// Greedy farthest point sampling: one sub-block of a thread block per row,
// or one thread-block cluster per row when the row outgrows one block's
// shared memory.
//
// Replaces gspn_tpu/ops/fps.py::_fps_kernel (the Pallas TPU kernel that
// keeps the per-point min-distance buffer in VMEM and packs rows on
// sublanes; it sizes VMEM for whole-scene rows of 64k points).
//
// What bounds it on the card: the npoint-long dependent chain
// (distance update -> argmax -> next centre), not bytes or FLOPs: a row
// of N points is 16*N bytes and each step is ~10*N operations.
//
// fps_kernel<kPer> (N <= 14,272): a sub-block of T threads per row; thread
// t holds points t + i*T, i < kPer, and their running minimum in registers
// (at kPer = 16, above 8192 points, 1024 threads' registers cannot hold the
// coordinates too: they are read from shared memory, the minimum stays in
// registers). Every row also keeps its coordinates in dynamic shared
// memory. A pick is a dependent chain, and at 8192 points the update's
// instructions fill the SM, so the design shortens both:
//   - the update of kPer independent points a thread: the distance (8
//     rounded operations), the minimum, and a compare that keeps the best
//     (value, slot); slots ascend with the index, so strict > keeps the
//     lowest. The best point's coordinates are then read from shared
//     memory, in flight while the warp reduces;
//   - the warp's argmax in two redux.sync steps on an order-preserving
//     unsigned key of the value (__reduce_max_sync), then the lowest index
//     among the lanes at that key (__reduce_min_sync);
//   - one barrier: each warp's winning lane writes its candidate (key,
//     index, x, y, z) to a slot double-buffered by the pick's parity, the
//     sub-block meets at its own named barrier (bar.sync id, T), and every
//     warp merges the <= 32 candidates by the same rule itself. The
//     winner's coordinates travel in its candidate: no dependent load of
//     the next centre.
// A row of at most 256 points is one warp (no barrier at all), and short
// rows share a CTA of up to 128 threads, a sub-block each, so the SA
// levels' rows of 32-128 points are not a CTA each. gspn_fps picks kPer
// from N: the least power of two that fits the row in one warp up to 256
// points, 8 up to 8192 (1024 points: 128 threads; 8192: 1024), else 16.
// Padding slots (j >= N) hold -inf, below an invalid point's -1.
//
// fps_cluster_kernel<kPer> (longer rows, up to 16 x 14,272 points): a
// cluster of cs CTAs (2, 4, 8 or 16, chosen by the Python wrapper) shares
// one row. CTA r holds points [r*S, (r+1)*S), S = ceil(N/cs), as
// fps_kernel<kPer> holds a row: kPer points a thread and their running
// minimum in registers (the coordinates in shared memory too, and only
// there at kPer = 16), kPer the least power of two that fits the slice in
// 1024 threads (4 at 65536 points over 16 CTAs). A pick is fps_kernel's
// pick within the CTA (the update, redux.sync argmax, one named barrier,
// every warp merging the warps' candidates itself), then across the
// cluster by push, not pull: lanes 0..cs-1 of warp 0 each store the CTA's
// candidate (key, global index, coordinates) into slot [k & 1][rank] of
// one CTA's shared memory (itself included) with st.async, which completes
// 20 bytes on that CTA's mbarrier [k & 1]; every thread waits on its own
// CTA's mbarrier phase (thread 0 posts the cs * 20 bytes expected), then
// every warp merges the cs local slots with redux.sync, so every CTA picks
// the same next centre with no remote read and no cluster barrier on a
// pick's path.
// Double buffering for push: a CTA writes pick k+2 into a peer's slot
// (and mbarrier) k & 1 only after it has received that peer's pick k+1
// candidate, which the peer sends only after its named barrier of pick
// k+1, which each of its warps reaches only after it has waited for and
// merged pick k: so the slot is read and the mbarrier's phase of pick k is
// complete before pick k+2's bytes arrive (they may arrive before the
// peer's thread 0 posts pick k+2's expected bytes: the transaction count
// goes below 0 and the phase cannot complete without that arrival). A
// cluster barrier after the mbarriers' initialisation comes before any
// push, and one before exit keeps every CTA's shared memory alive until
// no peer can still store into it. A CTA's candidate starts at (-inf,
// its first slot), below any point's value (-1 for an invalid one), so a
// CTA whose slice ends before S never wins.
//
// Contract (fps.py:_fps_single_xla): invalid points start at -1 and are
// never picked while a valid one remains; the first pick is the first
// valid point of the whole row (0 if none); ties go to the lowest index.
// Both kernels are bitwise the plain PyTorch version.

#include <cooperative_groups.h>

#include "common.cuh"

// the kernels live in gspn:: (their names carry it, so that a sanitizer or
// profiler can pick them out); the C entry points below use them unqualified
using namespace gspn;

namespace gspn {
namespace {

namespace cg = cooperative_groups;

constexpr int kFpsMaxSub = 4;        // rows (sub-blocks) a CTA
constexpr int kFpsSubThreads = 128;  // short rows share a CTA up to this
constexpr int kFpsMaxClusterSize = 16;
constexpr unsigned kPushBytes = 20;  // a pushed candidate: 5 words

// A float's order as an unsigned key: larger float, larger key (-inf, the
// padding, lowest of the values here).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A pick's candidate: key of its value, index, coordinates.
struct KeyCand {
  unsigned key;
  unsigned idx;
  float x, y, z;
};

// The cluster's slot of one CTA's candidate, 16-byte aligned for st.async.
struct __align__(16) PushSlot {
  unsigned key, idx;
  float x, y, z;
  unsigned pad[3];
};

// A candidate below every other: what a lane without one merges.
__device__ __forceinline__ KeyCand no_cand() {
  return KeyCand{0u, 0xffffffffu, 0.f, 0.f, 0.f};
}

// The warp's argmax, in every lane: the largest key, then the lowest index
// holding it, with that point's coordinates (indices are unique, so one
// lane holds the winner).
__device__ __forceinline__ KeyCand warp_argmax(const KeyCand& c) {
  const unsigned key = __reduce_max_sync(gspn::kFullMask, c.key);
  const unsigned idx =
      __reduce_min_sync(gspn::kFullMask, c.key == key ? c.idx : 0xffffffffu);
  const int src =
      __ffs(__ballot_sync(gspn::kFullMask, c.key == key && c.idx == idx)) - 1;
  return KeyCand{key, idx, __shfl_sync(gspn::kFullMask, c.x, src),
                 __shfl_sync(gspn::kFullMask, c.y, src),
                 __shfl_sync(gspn::kFullMask, c.z, src)};
}

__device__ __forceinline__ void sub_block_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The argmax of a sub-block of nw warps (named barrier `bar`), in every
// warp: each warp's winning lane writes its candidate to slot[warp], the
// sub-block meets at its barrier, and every warp merges the <= 32
// candidates by the same rule itself. `slot` is double-buffered by the
// pick's parity: a warp writes it again two picks on, after a barrier that
// every warp reaches only after reading it.
__device__ __forceinline__ KeyCand block_argmax(KeyCand c, KeyCand* slot,
                                                int nw, int warp, int lane,
                                                int bar, int threads) {
  if (nw == 1) return warp_argmax(c);
  const unsigned key = __reduce_max_sync(gspn::kFullMask, c.key);
  const unsigned idx =
      __reduce_min_sync(gspn::kFullMask, c.key == key ? c.idx : 0xffffffffu);
  if (c.key == key && c.idx == idx) slot[warp] = c;
  sub_block_sync(bar, threads);
  return warp_argmax(lane < nw ? slot[lane] : no_cand());
}

// A thread's points of a row (or of a cluster CTA's slice): t + i * tpr,
// i < kPer, and their running minimum distance, in registers (at kPer = 16
// the coordinates only in shared memory, sx/sy/sz, where every point's
// also are, for the winner's coordinates).
template <int kPer>
struct RowPoints {
  static constexpr bool kRegCoords = kPer <= 8;
  float px[kRegCoords ? kPer : 1], py[kRegCoords ? kPer : 1],
      pz[kRegCoords ? kPer : 1];
  float md[kPer];

  // Load the cnt points at p (validity at v, or null) into the registers
  // and sx/sy/sz (zeros past cnt, whose minimum is -inf); returns the
  // thread's first valid index, `base` + slot, or 0xffffffff.
  __device__ __forceinline__ unsigned load(const float* p, const uint8_t* v,
                                           int cnt, unsigned base, float* sx,
                                           float* sy, float* sz, int t,
                                           int tpr) {
    unsigned first = 0xffffffffu;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = t + i * tpr;
      float x = 0.f, y = 0.f, z = 0.f;
      md[i] = -CUDART_INF_F;
      if (j < cnt) {
        x = p[3 * j];
        y = p[3 * j + 1];
        z = p[3 * j + 2];
        const bool ok = v == nullptr || v[j] != 0;
        md[i] = ok ? 1e10f : -1.0f;
        if (ok && base + j < first) first = base + j;
      }
      sx[j] = x;
      sy[j] = y;
      sz[j] = z;
      if constexpr (kRegCoords) {
        px[i] = x;
        py[i] = y;
        pz[i] = z;
      }
    }
    return first;
  }

  // Update the minima against the centre c and return the thread's best
  // (value, index base + slot, coordinates); slots ascend with the index,
  // so strict > keeps the lowest. The coordinates load from shared memory
  // while the caller's warp reduces.
  __device__ __forceinline__ KeyCand update(const float* sx, const float* sy,
                                            const float* sz, int t, int tpr,
                                            float cx, float cy, float cz,
                                            unsigned base) {
    float bv = -CUDART_INF_F;
    int bs = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float x, y, z;
      if constexpr (kRegCoords) {
        x = px[i];
        y = py[i];
        z = pz[i];
      } else {
        x = sx[t + i * tpr];
        y = sy[t + i * tpr];
        z = sz[t + i * tpr];
      }
      const float m = fminf(md[i], gspn::sqdist(x, y, z, cx, cy, cz));
      md[i] = m;
      if (m > bv) {
        bv = m;
        bs = i;
      }
    }
    const unsigned j = t + bs * tpr;
    return KeyCand{order_key(bv), base + j, sx[j], sy[j], sz[j]};
  }
};

template <int kPer>
__global__ void __launch_bounds__(1024)
    fps_kernel(const float* __restrict__ xyz,
               const uint8_t* __restrict__ valid, int rows, int n, int npoint,
               int tpr, int* __restrict__ out) {
  extern __shared__ float fps_smem[];  // x, y, z of each sub-block's row
  __shared__ KeyCand cand[kFpsMaxSub][2][32];
  __shared__ unsigned first_s[kFpsMaxSub][32];

  const int sub = threadIdx.x / tpr;
  const int t = threadIdx.x - sub * tpr;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nw = tpr >> 5;
  const int row = blockIdx.x * (blockDim.x / tpr) + sub;
  if (row >= rows) return;  // a whole sub-block: no other waits for it
  const int bar = sub + 1;  // named barrier 0 is __syncthreads
  const int span = tpr * kPer;  // the row's slots, padding included
  const float* p = xyz + static_cast<size_t>(row) * n * 3;
  const uint8_t* v = valid ? valid + static_cast<size_t>(row) * n : nullptr;
  int* o = out + static_cast<size_t>(row) * npoint;
  float* sx = fps_smem + sub * 3 * span;
  float* sy = sx + span;
  float* sz = sy + span;

  RowPoints<kPer> pts;
  unsigned first = pts.load(p, v, n, 0u, sx, sy, sz, t, tpr);
  first = __reduce_min_sync(gspn::kFullMask, first);
  if (nw > 1) {
    if (lane == 0) first_s[sub][warp] = first;
    sub_block_sync(bar, tpr);  // also publishes the shared coordinates
    first = __reduce_min_sync(gspn::kFullMask,
                              lane < nw ? first_s[sub][lane] : 0xffffffffu);
  } else {
    __syncwarp();
  }
  const int prev = first < static_cast<unsigned>(n) ? first : 0;
  if (t == 0) o[0] = prev;
  float cx = sx[prev], cy = sy[prev], cz = sz[prev];

  for (int k = 1; k < npoint; ++k) {
    const KeyCand c =
        block_argmax(pts.update(sx, sy, sz, t, tpr, cx, cy, cz, 0u),
                     cand[sub][k & 1], nw, warp, lane, bar, tpr);
    if (t == 0) o[k] = static_cast<int>(c.idx);
    cx = c.x;
    cy = c.y;
    cz = c.z;
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The same shared-memory address in cluster CTA `rank`.
__device__ __forceinline__ unsigned cluster_addr(unsigned addr,
                                                 unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Store c into the slot at cluster address `dst`, completing kPushBytes
// on the mbarrier at cluster address `bar` (both in the same CTA).
__device__ __forceinline__ void push(unsigned dst, unsigned bar,
                                     const KeyCand& c) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(dst),
      "r"(c.key), "r"(c.idx), "r"(__float_as_uint(c.x)),
      "r"(__float_as_uint(c.y)), "r"(bar)
      : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];" ::"r"(dst + 16),
      "r"(__float_as_uint(c.z)), "r"(bar)
      : "memory");
}

// Wait until the phase of parity `parity` of the local mbarrier completes.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

template <int kPer>
__global__ void __launch_bounds__(1024, 1)
    fps_cluster_kernel(const float* __restrict__ xyz,
                       const uint8_t* __restrict__ valid, int n, int slice,
                       int npoint, int* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const unsigned rank = cluster.block_rank();
  extern __shared__ float fps_smem[];  // x, y, z of the slice's slots
  __shared__ KeyCand cand[2][32];
  __shared__ PushSlot slots[2][kFpsMaxClusterSize];
  __shared__ __align__(8) unsigned long long mbar[2];
  __shared__ unsigned first_s[32];
  __shared__ unsigned s_first;

  const int tpr = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nw = tpr >> 5;
  const int span = tpr * kPer;
  const int row = blockIdx.x / cs;
  const unsigned lo = rank * slice;
  const int cnt = max(0, min(n - static_cast<int>(lo), slice));
  const float* p = xyz + static_cast<size_t>(row) * n * 3;
  const uint8_t* v = valid ? valid + static_cast<size_t>(row) * n : nullptr;
  int* o = out + static_cast<size_t>(row) * npoint;
  float* sx = fps_smem;
  float* sy = sx + span;
  float* sz = sy + span;

  RowPoints<kPer> pts;
  unsigned first = pts.load(p + 3 * static_cast<size_t>(lo),
                            v ? v + lo : nullptr, cnt, lo, sx, sy, sz, t, tpr);
  first = __reduce_min_sync(gspn::kFullMask, first);
  if (lane == 0) first_s[warp] = first;
  if (t == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(&mbar[b]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    unsigned f = 0xffffffffu;
    for (int w = 0; w < nw; ++w) f = min(f, first_s[w]);
    s_first = f;
  }
  // every CTA has published its first valid point and initialised its
  // mbarriers before any peer reads the one or pushes to the others
  cluster.sync();

  // the cluster-wide first valid point: the least of the CTAs' s_first
  first = __reduce_min_sync(
      gspn::kFullMask,
      lane < cs ? *cluster.map_shared_rank(&s_first, lane) : 0xffffffffu);
  const int prev = first < static_cast<unsigned>(n) ? first : 0;
  float cx = p[3 * prev], cy = p[3 * prev + 1], cz = p[3 * prev + 2];
  if (rank == 0 && t == 0) o[0] = prev;

  // lane r of warp 0 pushes to CTA r: its slot and mbarrier of parity 0;
  // parity 1's lie sizeof(PushSlot) * kFpsMaxClusterSize and 8 bytes on
  const unsigned own_bar = smem_u32(&mbar[0]);
  unsigned dst = 0, dst_bar = 0;
  if (warp == 0 && lane < cs) {
    dst = cluster_addr(smem_u32(&slots[0][rank]), lane);
    dst_bar = cluster_addr(own_bar, lane);
  }

  for (int k = 1; k < npoint; ++k) {
    const int b = k & 1;
    if (t == 0)
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
              own_bar + 8 * b),
          "r"(kPushBytes * cs)
          : "memory");
    const KeyCand c =
        block_argmax(pts.update(sx, sy, sz, t, tpr, cx, cy, cz, lo), cand[b],
                     nw, warp, lane, 1, tpr);
    if (warp == 0 && lane < cs)
      push(dst + b * sizeof(PushSlot) * kFpsMaxClusterSize, dst_bar + 8 * b,
           c);
    // mbarrier b's (k - 1) / 2-th phase: pick k's cs candidates
    mbar_wait(own_bar + 8 * b, ((k - 1) >> 1) & 1);
    const KeyCand best = warp_argmax(
        lane < cs ? KeyCand{slots[b][lane].key, slots[b][lane].idx,
                            slots[b][lane].x, slots[b][lane].y,
                            slots[b][lane].z}
                  : no_cand());
    if (rank == 0 && t == 0) o[k] = static_cast<int>(best.idx);
    cx = best.x;
    cy = best.y;
    cz = best.z;
  }
  cluster.sync();  // no CTA exits while a peer may still push to it
}

}  // namespace
}  // namespace gspn

extern "C" const char* gspn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace gspn {
namespace {

template <int kPer>
cudaError_t launch_fps(const float* xyz, const uint8_t* valid, int rows, int n,
                       int npoint, int* out, cudaStream_t stream) {
  const int tpr = ((n + kPer - 1) / kPer + 31) / 32 * 32;  // threads a row
  int per_cta = kFpsSubThreads / tpr;
  per_cta = per_cta < 1 ? 1 : (per_cta > kFpsMaxSub ? kFpsMaxSub : per_cta);
  if (per_cta > rows) per_cta = rows;
  const size_t smem =
      static_cast<size_t>(per_cta) * tpr * kPer * 3 * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<kPer>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fps_kernel<kPer><<<(rows + per_cta - 1) / per_cta, per_cta * tpr, smem,
                     stream>>>(xyz, valid, rows, n, npoint, tpr, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gspn

extern "C" int gspn_fps(const float* xyz, const uint8_t* valid, int rows, int n,
                        int npoint, int* out, cudaStream_t stream) {
  if (n < 1 || n > 16 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  // points a thread: one warp a row up to 256 points, 8 up to 8192, then 16
  const int warp_per = (n + 31) / 32;
  cudaError_t err;
  if (warp_per <= 1)
    err = launch_fps<1>(xyz, valid, rows, n, npoint, out, stream);
  else if (warp_per <= 2)
    err = launch_fps<2>(xyz, valid, rows, n, npoint, out, stream);
  else if (warp_per <= 4)
    err = launch_fps<4>(xyz, valid, rows, n, npoint, out, stream);
  else if (n <= 8192)
    err = launch_fps<8>(xyz, valid, rows, n, npoint, out, stream);
  else
    err = launch_fps<16>(xyz, valid, rows, n, npoint, out, stream);
  return static_cast<int>(err);
}

namespace gspn {
namespace {

// Launch fps_cluster_kernel<kPer> over rows of n points, a cluster of cs
// CTAs a row, each of ceil(ceil(n / cs) / kPer) threads rounded up to a
// warp; or, when max_clusters is not null, only ask how many such clusters
// can be resident at once (0: the cluster cannot run).
template <int kPer>
cudaError_t cluster_launch(const float* xyz, const uint8_t* valid, int rows,
                           int n, int npoint, int cs, int* out,
                           cudaStream_t stream, int* max_clusters) {
  const int slice = (n + cs - 1) / cs;
  const int threads = ((slice + kPer - 1) / kPer + 31) / 32 * 32;
  const size_t smem =
      static_cast<size_t>(threads) * kPer * 3 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_cluster_kernel<kPer>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cs > 8) {
    err = cudaFuncSetAttribute(fps_cluster_kernel<kPer>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * cs));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters)
    return cudaOccupancyMaxActiveClusters(max_clusters,
                                          fps_cluster_kernel<kPer>, &cfg);
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<kPer>, xyz, valid, n,
                           slice, npoint, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// cluster_launch at the points a thread that fit a slice of
// ceil(n / cs) points in 1024 threads: the least power of two.
cudaError_t cluster_dispatch(const float* xyz, const uint8_t* valid, int rows,
                             int n, int npoint, int cs, int* out,
                             cudaStream_t stream, int* max_clusters) {
  if (cs < 2 || cs > kFpsMaxClusterSize || (cs & (cs - 1)) != 0 || n < 1)
    return cudaErrorInvalidValue;
  const int slice = (n + cs - 1) / cs;
  if (slice <= 1024)
    return cluster_launch<1>(xyz, valid, rows, n, npoint, cs, out, stream,
                             max_clusters);
  if (slice <= 2048)
    return cluster_launch<2>(xyz, valid, rows, n, npoint, cs, out, stream,
                             max_clusters);
  if (slice <= 4096)
    return cluster_launch<4>(xyz, valid, rows, n, npoint, cs, out, stream,
                             max_clusters);
  if (slice <= 8192)
    return cluster_launch<8>(xyz, valid, rows, n, npoint, cs, out, stream,
                             max_clusters);
  if (slice <= 16384)
    return cluster_launch<16>(xyz, valid, rows, n, npoint, cs, out, stream,
                              max_clusters);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace gspn

// How many clusters of `cs` CTAs, each holding a slice of a row of `n`
// points, can be resident at once (0: the cluster cannot run).
extern "C" int gspn_fps_cluster_occupancy(int n, int cs, int* max_clusters) {
  *max_clusters = 0;
  return static_cast<int>(cluster_dispatch(nullptr, nullptr, 1, n, 1, cs,
                                           nullptr, nullptr, max_clusters));
}

extern "C" int gspn_fps_cluster(const float* xyz, const uint8_t* valid, int rows,
                                int n, int npoint, int cs, int* out,
                                cudaStream_t stream) {
  return static_cast<int>(cluster_dispatch(xyz, valid, rows, n, npoint, cs,
                                           out, stream, nullptr));
}
