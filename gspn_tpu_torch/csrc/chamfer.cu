// Nearest valid source per target, in one direction or both: the argmins
// behind the chamfer loss.
//
// Replaces gspn_tpu/ops/chamfer.py::_nn_kernel (called through
// _argmin_pallas), the Pallas kernel that lays a tile of targets along
// sublanes and the whole padded source row along lanes, builds the
// (targets x sources) squared-distance tile in VMEM and reduces it with one
// argmin. The JAX package calls it twice for the chamfer loss, once each
// way; here one launch gives both.
//
// Contract (ops/common.py masked_sqdist + argmin, ops/chamfer.py
// nn_argmin_pair): d2 = dx*dx + dy*dy + dz*dz in that order with
// round-to-nearest intrinsics (d(a, b) is bitwise d(b, a): b - a is exactly
// -(a - b)). Row direction: idx1[i] is the nearest source of target i, an
// invalid source (valid2 false) counting as 1e10. Column direction:
// idx2[j] is the nearest target of source j, an invalid target (valid1
// false) counting as 1e10. Ties go to the lowest index in both, so a row
// whose candidates are all invalid gets index 0. Bitwise equal to the plain
// PyTorch version.
//
// What bounds it on the card: the N*M distance evaluations, 8 float32
// operations each (no FMA), and one compare a direction; inputs and outputs
// are a few bytes a point. At the training step's shapes (256 rows x 256
// targets x 256 sources) the operations bound is ~0.0050 ms for both ways
// at 33.5 T float32 operations/s, the H100's lanes without FMA. Design:
// - A CTA takes 256 targets (a pass) of one row, staged once in shared
//   memory as float4 (x, y, z, invalid flag), and sweeps all its sources,
//   staged 256 at a time the same way, double-buffered. Lane p holds
//   targets 8p..8p+7 in registers; warp q takes the tile's sources
//   32q..32q+31, so a source read is one broadcast LDS.128 for eight
//   distances, and the lanes of a warp meet the same source flag (a
//   uniform branch, no select a pair).
// - Each distance is computed once and reduced twice: into the target's
//   running (distance, index) in registers (strict <, sources in index
//   order), and by fminf along the thread's eight targets into a column
//   value that goes to shared memory (one instruction a pair, no index).
//   After the tile, a thread a source finds the first lane holding the
//   least value, then the first of that lane's targets at it by computing
//   its eight distances again: the lowest index at the minimum, as the
//   plain argmin has it.
// - A row of up to 256 targets is one CTA, which writes both directions'
//   results itself. Longer rows are split over up to 16 CTAs (16 x 4096
//   rows fill the card with 256 CTAs), each taking a run of consecutive
//   256-target tiles, one a pass. A CTA keeps the column partial of every
//   source over its passes in its slot of a scratch (written at its first
//   pass, so nothing needs initialising; a later pass replaces it only when
//   strictly closer, read and written by the same thread). The row's last
//   CTA to finish, found by a per-row count that it resets, merges the
//   slots in rank (target) order. No cluster: the CTAs are scheduled as
//   freely as the one-way form's, and the result does not depend on the
//   order they run in.
// - At the end of a pass, the warps' row partials (each over its own
//   slices of the source tiles) are merged by (distance, index).
// The one-direction form (idx2 null) is the same kernel without the column
// work (kCols false), a CTA a 256-target tile.

#include "common.cuh"

// the kernels live in gspn:: (their names carry it, so that a sanitizer or
// profiler can pick them out); the C entry points below use them unqualified
using namespace gspn;

namespace gspn {
namespace {

constexpr int kLanes = 32;                 // a lane a group of targets
constexpr int kWarps = 8;                  // a warp a slice of each source tile
constexpr int kThreads = kLanes * kWarps;  // 256
constexpr int kPer = 8;                    // targets a thread
constexpr int kTargets = kLanes * kPer;    // 256 targets a CTA and pass
constexpr int kSources = kThreads;         // 256 sources a tile, one staged a thread
constexpr int kSlice = kSources / kWarps;  // 32 sources a warp's slice of a tile
constexpr int kMaxSplit = 16;              // most CTAs a row, two-way
constexpr int kColPad = kSources + 1;  // column partials [lane][source], padded
constexpr int kRowPad = kLanes * (kPer + 1);  // row partials [warp][lane * 9 + r]

template <bool kCols>
struct Shared {
  float4 src[2][kSources];  // (x, y, z, 1 where valid2 is false)
  float4 tgt[kTargets];     // (x, y, z, 1 where valid1 is false), swizzled
  // column partials' values [lane][source of the tile]; at a pass's end the
  // row partials' distances [warp][lane * 9 + r]
  float part[kCols ? kLanes * kColPad : kWarps * kRowPad];
  int row_i[kWarps * kRowPad];
};

// Target t's slot: lane p's eight targets 8p..8p+7 land in distinct bank
// groups for the eight lanes a 16-byte load serves at once.
__device__ __forceinline__ int tslot(int t) { return t ^ ((t >> 3) & 7); }

// (best, index) <- (d, j) when d < best: sources arrive in index order, so
// a tie keeps the earlier one.
__device__ __forceinline__ void take_min(float d, int j, float& best, int& bi) {
  if (d < best) {
    best = d;
    bi = j;
  }
}

// One source (index j, uniform across the warp) against the thread's kPer
// targets: the targets' running row minima, and the least column distance
// over these targets (fminf passes over a padded target's NaN). kInvalid:
// the source is padded for the row direction (its row candidate is exactly
// 1e10).
template <bool kCols, bool kValid1, bool kInvalid>
__device__ __forceinline__ float scan_source(const float4 p, int j,
                                             const float (&tx)[kPer],
                                             const float (&ty)[kPer],
                                             const float (&tz)[kPer],
                                             unsigned inv1, float (&rb)[kPer],
                                             int (&ri)[kPer]) {
  float cb = CUDART_NAN_F;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const float d = gspn::sqdist(tx[r], ty[r], tz[r], p.x, p.y, p.z);
    take_min(kInvalid ? 1e10f : d, j, rb[r], ri[r]);
    if constexpr (kCols)
      cb = fminf(cb, kValid1 && ((inv1 >> r) & 1u) ? 1e10f : d);
  }
  return cb;
}

// Grid (CTAs a row, batch rows): CTA rank takes the row's target tiles
// [rank * tiles / CTAs, (rank + 1) * tiles / CTAs). A target past n and a
// source past m have NaN coordinates: their distances are NaN and win no
// compare. part_d / part_i: each CTA's column partials over its passes,
// [batch row][rank][source]; done: a count a batch row, zero between
// launches.
template <bool kCols, bool kValid1, bool kValid2>
__global__ void __launch_bounds__(kThreads) nn_argmin_kernel(
    const float* __restrict__ xyz1, const float* __restrict__ xyz2,
    const uint8_t* __restrict__ valid1, const uint8_t* __restrict__ valid2,
    int n, int m, int* __restrict__ idx1, int* __restrict__ idx2,
    float* __restrict__ part_d, int* __restrict__ part_i, unsigned* __restrict__ done) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared<kCols>& sh = *reinterpret_cast<Shared<kCols>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const float* tgt = xyz1 + static_cast<size_t>(b) * n * 3;
  const float* src = xyz2 + static_cast<size_t>(b) * m * 3;
  const uint8_t* v1 = kValid1 ? valid1 + static_cast<size_t>(b) * n : nullptr;
  const uint8_t* v2 = kValid2 ? valid2 + static_cast<size_t>(b) * m : nullptr;
  const int tiles = (m + kSources - 1) / kSources;
  const long t_tiles = (static_cast<long>(n) + kTargets - 1) / kTargets;
  const int cs = static_cast<int>(gridDim.x);
  const int rank = static_cast<int>(blockIdx.x);
  const int t_lo = static_cast<int>(rank * t_tiles / cs);
  const int t_hi = static_cast<int>((rank + 1) * t_tiles / cs);
  // one CTA and one pass a row: the CTA's column result is the row's
  const bool direct = t_tiles == 1;
  const size_t slot = (static_cast<size_t>(b) * cs + rank) * m;

  auto fetch = [&](int j) {
    return j < m ? make_float4(src[3 * j], src[3 * j + 1], src[3 * j + 2],
                               kValid2 && !v2[j] ? 1.f : 0.f)
                 : make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, 0.f);
  };

  for (int pass = t_lo; pass < t_hi; ++pass) {
    const int t_base = pass * kTargets;
    {  // stage the pass's targets and the first source tile, a point a thread
      const int t = t_base + tid;
      sh.tgt[tslot(tid)] =
          t < n ? make_float4(tgt[3 * t], tgt[3 * t + 1], tgt[3 * t + 2],
                              kValid1 && !v1[t] ? 1.f : 0.f)
                : make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, 0.f);
      sh.src[0][tid] = fetch(tid);
    }
    __syncthreads();
    float tx[kPer], ty[kPer], tz[kPer], rb[kPer];
    int ri[kPer];
    unsigned inv1 = 0;  // bit r: target 8 lane + r is invalid (valid1 false)
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const float4 q = sh.tgt[tslot(lane * kPer + r)];
      tx[r] = q.x;
      ty[r] = q.y;
      tz[r] = q.z;
      if (kValid1 && q.w != 0.f) inv1 |= 1u << r;
      rb[r] = CUDART_INF_F;
      ri[r] = warp * kSlice;  // the first source this thread meets
    }

    for (int k = 0; k < tiles; ++k) {
      const int base = k * kSources;
      const bool more = k + 1 < tiles;
      float4 pre;
      if (more) pre = fetch(base + kSources + tid);
      const float4* cur = sh.src[k & 1];
      const int j0 = base + warp * kSlice;
      const int len = min(kSlice, m - j0);  // the warp's sources below m
#pragma unroll 2
      for (int s = 0; s < len; ++s) {
        const float4 p = cur[warp * kSlice + s];
        float cb;
        if (kValid2 && p.w != 0.f)
          cb = scan_source<kCols, kValid1, true>(p, j0 + s, tx, ty, tz, inv1, rb, ri);
        else
          cb = scan_source<kCols, kValid1, false>(p, j0 + s, tx, ty, tz, inv1, rb, ri);
        if constexpr (kCols) sh.part[lane * kColPad + warp * kSlice + s] = cb;
      }
      if (more) sh.src[(k + 1) & 1][tid] = pre;
      __syncthreads();
      const int j = base + tid;
      if (kCols && j < m) {
        // the CTA's column result of source j: the first lane holding the
        // least distance (four runs of eight lanes, then the runs in
        // order), then the first of that lane's targets at it (targets
        // ascend with the lane, then within it)
        float dq[4];
        int lq[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          dq[g] = CUDART_INF_F;
          lq[g] = -1;
#pragma unroll
          for (int l = 8 * g; l < 8 * g + 8; ++l) {
            const float dl = sh.part[l * kColPad + tid];
            if (dl < dq[g]) {
              dq[g] = dl;
              lq[g] = l;
            }
          }
        }
        float d = dq[0];
        int bl = lq[0];
#pragma unroll
        for (int g = 1; g < 4; ++g) {
          if (dq[g] < d) {
            d = dq[g];
            bl = lq[g];
          }
        }
        int i = t_base;  // every distance +inf (or NaN): the first target
        if (bl >= 0) {
          const float4 p = cur[tid];
          for (int r = kPer - 1; r >= 0; --r) {
            const float4 q = sh.tgt[tslot(bl * kPer + r)];
            const float dc = kValid1 && q.w != 0.f
                                 ? 1e10f
                                 : gspn::sqdist(q.x, q.y, q.z, p.x, p.y, p.z);
            if (dc == d) i = t_base + bl * kPer + r;
          }
        }
        if (direct) {
          idx2[static_cast<size_t>(b) * m + j] = i;
        } else if (pass == t_lo || d < part_d[slot + j]) {
          part_d[slot + j] = d;
          part_i[slot + j] = i;
        }
      }
      if constexpr (kCols) __syncthreads();  // the partials are rewritten next tile
    }

    // the row results of the pass's targets: the warps' partials (each over
    // its slices of the tiles) merged by (distance, index)
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      sh.part[warp * kRowPad + lane * (kPer + 1) + r] = rb[r];
      sh.row_i[warp * kRowPad + lane * (kPer + 1) + r] = ri[r];
    }
    __syncthreads();
    const int at = tid / kPer * (kPer + 1) + tid % kPer;
    float d = sh.part[at];
    int i = sh.row_i[at];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float dw = sh.part[w * kRowPad + at];
      const int iw = sh.row_i[w * kRowPad + at];
      if (dw < d || (dw == d && iw < i)) {
        d = dw;
        i = iw;
      }
    }
    if (t_base + tid < n) idx1[static_cast<size_t>(b) * n + t_base + tid] = i;
    __syncthreads();  // the staged points and the partials are reused
  }

  if (kCols && !direct) {
    // the row's last CTA to finish merges the CTAs' slots, in rank (target)
    // order, and resets the row's count for the next launch
    __shared__ bool last;
    __threadfence();  // this CTA's slot is visible before it is counted
    __syncthreads();
    if (tid == 0) last = atomicAdd(done + b, 1u) == static_cast<unsigned>(cs - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    // a thread two sources at a time, every slot's distance loaded before
    // any is compared, then the one index: two round trips to L2 a pair of
    // sources, not one a slot
    const float* pd = part_d + static_cast<size_t>(b) * cs * m;
    const int* pi = part_i + static_cast<size_t>(b) * cs * m;
    for (int j0 = tid; j0 < m; j0 += 2 * kThreads) {
      float dv[2][kMaxSplit];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + u * kThreads;
#pragma unroll
        for (int r = 0; r < kMaxSplit; ++r)
          dv[u][r] = r < cs && j < m ? __ldcg(pd + static_cast<size_t>(r) * m + j)
                                     : CUDART_INF_F;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + u * kThreads;
        float bd = dv[u][0];
        int br = 0;
#pragma unroll
        for (int r = 1; r < kMaxSplit; ++r) {
          if (dv[u][r] < bd) {
            bd = dv[u][r];
            br = r;
          }
        }
        if (j < m)
          idx2[static_cast<size_t>(b) * m + j] = __ldcg(pi + static_cast<size_t>(br) * m + j);
      }
    }
    if (tid == 0) done[b] = 0;
  }
}

// A refused call's error is also the runtime's last error: clear it, so that
// the next launch's check does not report it again.
cudaError_t refused(cudaError_t err) {
  cudaGetLastError();
  return err;
}

template <bool kCols, bool kValid1, bool kValid2>
cudaError_t launch(const float* xyz1, const float* xyz2, const uint8_t* valid1,
                   const uint8_t* valid2, int nb, int n, int m, int ctas, int* idx1,
                   int* idx2, float* scratch, unsigned* done, cudaStream_t stream) {
  auto kernel = nn_argmin_kernel<kCols, kValid1, kValid2>;
  const size_t smem = sizeof(Shared<kCols>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return refused(err);
  // scratch: part_d, part_i ([nb][ctas][m] each)
  const size_t parts = static_cast<size_t>(nb) * ctas * m;
  float* part_d = scratch;
  int* part_i = scratch ? reinterpret_cast<int*>(scratch + parts) : nullptr;
  kernel<<<dim3(static_cast<unsigned>(ctas), static_cast<unsigned>(nb)), kThreads, smem,
           stream>>>(xyz1, xyz2, valid1, valid2, n, m, idx1, idx2, part_d, part_i, done);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gspn

// idx1 (nb, n): each xyz1 target's nearest valid xyz2 source; idx2 (nb, m),
// or null for the row direction alone: each source's nearest valid target.
// ctas: CTAs a row (1-16; ops/chamfer.py nn_argmin_plan, at most the row's
// 256-target tiles), read only with idx2. When a row takes more than one
// tile, scratch: 2 * ctas * nb * m floats, and done: nb counts, zero (the
// kernel leaves them zero). Else both are unused.
extern "C" int gspn_nn_argmin(const float* xyz1, const float* xyz2,
                              const uint8_t* valid1, const uint8_t* valid2,
                              int nb, int n, int m, int ctas, int* idx1,
                              int* idx2, float* scratch, unsigned* done,
                              cudaStream_t stream) {
  if (nb > 65535 || nb < 0 || n < 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || n == 0 || m == 0) return static_cast<int>(cudaGetLastError());
  const long tiles = (static_cast<long>(n) + kTargets - 1) / kTargets;
  cudaError_t err;
  if (idx2 == nullptr) {
    if (tiles > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
    err = valid2 ? launch<false, false, true>(xyz1, xyz2, nullptr, valid2, nb, n, m,
                                              static_cast<int>(tiles), idx1, nullptr,
                                              nullptr, nullptr, stream)
                 : launch<false, false, false>(xyz1, xyz2, nullptr, nullptr, nb, n, m,
                                               static_cast<int>(tiles), idx1, nullptr,
                                               nullptr, nullptr, stream);
    return static_cast<int>(err);
  }
  if (ctas < 1 || ctas > kMaxSplit || ctas > tiles ||
      (tiles > 1 && (scratch == nullptr || done == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (valid1 && valid2)
    err = launch<true, true, true>(xyz1, xyz2, valid1, valid2, nb, n, m, ctas, idx1, idx2,
                                   scratch, done, stream);
  else if (valid1)
    err = launch<true, true, false>(xyz1, xyz2, valid1, nullptr, nb, n, m, ctas, idx1, idx2,
                                    scratch, done, stream);
  else if (valid2)
    err = launch<true, false, true>(xyz1, xyz2, nullptr, valid2, nb, n, m, ctas, idx1, idx2,
                                    scratch, done, stream);
  else
    err = launch<true, false, false>(xyz1, xyz2, nullptr, nullptr, nb, n, m, ctas, idx1,
                                     idx2, scratch, done, stream);
  return static_cast<int>(err);
}
