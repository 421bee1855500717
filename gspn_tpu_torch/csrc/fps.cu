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
// fps_cluster_kernel (longer rows, up to 16 x 14,272 points): a cluster of
// cs CTAs (2, 4, 8 or 16, chosen by the Python wrapper) shares one row.
// CTA r keeps points [r*S, (r+1)*S), S = ceil(N/cs), and their min-distance
// buffer in its own shared memory (64 KB a CTA for N = 65536 at cs = 16).
// Each pick: every CTA updates its slice and reduces its own (value,
// global index, coordinates) candidate (warp shuffles, then one warp over
// the warps' results through shared memory), writes it to a slot in its
// shared memory, and meets the others at one cluster barrier; then warp 0
// of every CTA reads the cs candidates through distributed shared memory
// (lane r from CTA r), merges them with the same (value, lowest index)
// rule and hands the result to its CTA through shared memory, so every CTA
// picks the same next centre. (Every warp merging on its own, with no
// block barrier, costs 32*cs*cs remote reads a pick of the same few words,
// and was slower the larger the cluster.) The next centre's
// coordinates travel in the winning candidate, read in the same DSMEM
// round as its value: no further dependent load of the owner's shared
// memory or of device memory. The slot is double-buffered by the pick's
// parity: a CTA writes slot k&1 only after the barrier of pick k-1, which
// every CTA reaches only after it has read the slots of pick k-2. A
// CTA's candidate starts at (-inf, N), below any point's value (-1 for an
// invalid one), so a CTA whose slice ends before S never wins.
//
// Contract (fps.py:_fps_single_xla): invalid points start at -1 and are
// never picked while a valid one remains; the first pick is the first
// valid point (0 if none); ties go to the lowest index. Both kernels are
// bitwise the plain PyTorch version.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

constexpr int kFpsMaxSub = 4;        // rows (sub-blocks) a CTA
constexpr int kFpsSubThreads = 128;  // short rows share a CTA up to this

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

template <int kPer>
__global__ void __launch_bounds__(1024)
    fps_kernel(const float* __restrict__ xyz,
               const uint8_t* __restrict__ valid, int rows, int n, int npoint,
               int tpr, int* __restrict__ out) {
  constexpr bool kRegCoords = kPer <= 8;
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

  float px[kRegCoords ? kPer : 1], py[kRegCoords ? kPer : 1],
      pz[kRegCoords ? kPer : 1];
  float md[kPer];
  unsigned first = 0xffffffffu;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = t + i * tpr;
    float x = 0.f, y = 0.f, z = 0.f;
    md[i] = -CUDART_INF_F;
    if (j < n) {
      x = p[3 * j];
      y = p[3 * j + 1];
      z = p[3 * j + 2];
      const bool ok = v == nullptr || v[j] != 0;
      md[i] = ok ? 1e10f : -1.0f;
      if (ok && static_cast<unsigned>(j) < first) first = j;
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
    // this thread's best (value, slot); slots ascend with the index, so
    // strict > keeps the lowest
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
    // its coordinates load while the warp reduces
    const unsigned j = t + bs * tpr;
    KeyCand c{order_key(bv), j, sx[j], sy[j], sz[j]};
    if (nw == 1) {
      c = warp_argmax(c);
    } else {
      // the warp's winner writes its candidate itself
      const unsigned key = __reduce_max_sync(gspn::kFullMask, c.key);
      const unsigned idx =
          __reduce_min_sync(gspn::kFullMask, c.key == key ? j : 0xffffffffu);
      KeyCand* slot = cand[sub][k & 1];
      if (c.key == key && j == idx) slot[warp] = c;
      sub_block_sync(bar, tpr);
      c = lane < nw ? slot[lane] : KeyCand{0u, 0xffffffffu, 0.f, 0.f, 0.f};
      c = warp_argmax(c);
    }
    if (t == 0) o[k] = static_cast<int>(c.idx);
    cx = c.x;
    cy = c.y;
    cz = c.z;
  }
}

// One pick's candidate of one CTA: the best (value, global index) of its
// slice and that point's coordinates.
struct Candidate {
  float v;
  int i;
  float x, y, z;
};

// Argmax over the cs candidates of slot `slot` of every CTA of the
// cluster, by one warp (lane r reads CTA r's slot); the result is in
// lane 0.
__device__ __forceinline__ Candidate merge_cluster(cg::cluster_group& cluster,
                                                   Candidate* slot, int cs,
                                                   int n, int lane) {
  Candidate c{-CUDART_INF_F, n, 0.f, 0.f, 0.f};
  if (lane < cs) c = *cluster.map_shared_rank(slot, lane);
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(gspn::kFullMask, c.v, off);
    const int oi = __shfl_down_sync(gspn::kFullMask, c.i, off);
    const float ox = __shfl_down_sync(gspn::kFullMask, c.x, off);
    const float oy = __shfl_down_sync(gspn::kFullMask, c.y, off);
    const float oz = __shfl_down_sync(gspn::kFullMask, c.z, off);
    if (ov > c.v || (ov == c.v && oi < c.i)) c = Candidate{ov, oi, ox, oy, oz};
  }
  return c;
}

__global__ void __launch_bounds__(1024, 1)
    fps_cluster_kernel(const float* __restrict__ xyz,
                       const uint8_t* __restrict__ valid, int n, int slice,
                       int npoint, int* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + slice;
  float* sz = sy + slice;
  float* mind = sz + slice;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_first;
  __shared__ Candidate cand[2];
  __shared__ Candidate s_best;

  const int row = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lo = rank * slice;
  const int cnt = max(0, min(n - lo, slice));  // this CTA's points
  const float* p = xyz + static_cast<size_t>(row) * n * 3;
  const uint8_t* v = valid ? valid + static_cast<size_t>(row) * n : nullptr;
  int* o = out + static_cast<size_t>(row) * npoint;

  if (tid == 0) s_first = n;
  __syncthreads();
  int my_first = n;
  for (int j = tid; j < cnt; j += blockDim.x) {
    const int g = lo + j;
    sx[j] = p[3 * g];
    sy[j] = p[3 * g + 1];
    sz[j] = p[3 * g + 2];
    const bool ok = v == nullptr || v[g] != 0;
    mind[j] = ok ? 1e10f : -1.0f;
    if (ok && g < my_first) my_first = g;
  }
  if (my_first < n) atomicMin(&s_first, my_first);
  cluster.sync();  // every CTA has started and published its first valid point

  // the cluster-wide first valid point: the least of the CTAs' s_first
  int first = lane < cs ? *cluster.map_shared_rank(&s_first, lane) : n;
  for (int off = 16; off > 0; off >>= 1)
    first = min(first, __shfl_down_sync(gspn::kFullMask, first, off));
  first = __shfl_sync(gspn::kFullMask, first, 0);
  first = first < n ? first : 0;
  float cx = p[3 * first], cy = p[3 * first + 1], cz = p[3 * first + 2];
  if (rank == 0 && tid == 0) o[0] = first;

  for (int k = 1; k < npoint; ++k) {
    float bv = -CUDART_INF_F;
    int bi = n;
    for (int j = tid; j < cnt; j += blockDim.x) {
      const float d = gspn::sqdist(sx[j], sy[j], sz[j], cx, cy, cz);
      const float m = fminf(mind[j], d);
      mind[j] = m;
      if (m > bv) {  // j ascends within a thread: strict > keeps the lowest
        bv = m;
        bi = lo + j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(gspn::kFullMask, bv, off);
      const int oi = __shfl_down_sync(gspn::kFullMask, bi, off);
      argmax_merge(bv, bi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    Candidate* slot = &cand[k & 1];
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -CUDART_INF_F;
      bi = lane < nwarps ? red_i[lane] : n;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(gspn::kFullMask, bv, off);
        const int oi = __shfl_down_sync(gspn::kFullMask, bi, off);
        argmax_merge(bv, bi, ov, oi);
      }
      if (lane == 0) {
        const int l = bi < n ? bi - lo : 0;
        *slot = Candidate{bv, bi, sx[l], sy[l], sz[l]};
      }
    }
    cluster.sync();  // every CTA's candidate of pick k is in its slot
    if (warp == 0) {
      const Candidate best = merge_cluster(cluster, slot, cs, n, lane);
      if (lane == 0) {
        s_best = best;
        if (rank == 0) o[k] = best.i;
      }
    }
    __syncthreads();
    cx = s_best.x;
    cy = s_best.y;
    cz = s_best.z;
  }
  cluster.sync();  // no CTA exits while another may still read its slots
}

}  // namespace

extern "C" const char* gspn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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

namespace {

// Shared memory a cluster CTA needs for a slice of `slice` points, and the
// launch configuration of a cluster of `cs` CTAs per row (the attributes
// for the slice's dynamic shared memory and, above 8, a non-portable
// cluster size are set first).
cudaError_t cluster_config(int rows, int n, int cs, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           int* slice) {
  *slice = (n + cs - 1) / cs;
  const size_t smem = static_cast<size_t>(*slice) * 4 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cs > 8) {
    err = cudaFuncSetAttribute(fps_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(rows * cs));
  cfg->blockDim = dim3(1024);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// How many clusters of `cs` CTAs, each holding a slice of a row of `n`
// points, can be resident at once (0: the cluster cannot run).
extern "C" int gspn_fps_cluster_occupancy(int n, int cs, int* max_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int slice = 0;
  cudaError_t err = cluster_config(1, n, cs, nullptr, &cfg, attr, &slice);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(max_clusters, fps_cluster_kernel, &cfg));
}

extern "C" int gspn_fps_cluster(const float* xyz, const uint8_t* valid, int rows,
                                int n, int npoint, int cs, int* out,
                                cudaStream_t stream) {
  if (cs < 2 || cs > 16 || (cs & (cs - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int slice = 0;
  cudaError_t err = cluster_config(rows, n, cs, stream, &cfg, attr, &slice);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel, xyz, valid, n, slice,
                           npoint, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
