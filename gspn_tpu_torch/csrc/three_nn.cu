// Three nearest valid sources per target point.
//
// Replaces gspn_tpu/ops/interpolate.py::_three_nn_kernel (a (targets x
// sources) distance tile in VMEM, the top 3 by three masked min passes) and
// ::_three_nn_tiled_kernel (the same with the sources in 2048-lane chunks,
// a running top 3 carried across the sequential grid axis).
//
// What bounds it on the card: the N*M distance evaluations, 9 float
// operations each (no FMA) and a compare; the outputs are 24 bytes a target.
// Design:
// - Reuse: a thread owns T targets (1, 2 or 4) in registers; each source is
//   staged once as a float4 (x, y, z, invalid flag) in shared memory, so one
//   broadcast LDS.128 serves T targets.
// - Fill the card: the source range is split over S slices (1-32) of the
//   CTA's warps. A slice scans the sources of its own part of every tile and
//   keeps a partial top 3 with global indices; slice 0 merges the partial
//   lists lexicographically by (distance, index), so ties still go to the
//   lower source index.
// - Few insertions: where a slice is long, a thread compares a group of 32
//   sources with its targets' third distances as they stood before them (a
//   compare and a bit each, ~12 instructions a pair), then inserts only the
//   marked ones, in order. A warp pays for an insertion whenever one lane
//   makes it, so 32 wasted less than 8, 16 or 64. Where a slice holds a few
//   hundred sources or fewer, most lanes insert often anyway and each
//   source is inserted as it comes (G = 1, ~13 predicated instructions
//   more a pair). Deferring the marked sources to rounds that several lanes
//   share, or keeping their distances in registers, measured no faster
//   (PERF.md, section 6).
// - Staging: a tile holds 2 sources a thread; the next tile is loaded into
//   registers while the current one is scanned (one barrier a tile).
// T, S and G come from the Python rule three_nn_plan (ops/interpolate.py),
// so that a CPU test can check it; CTAs have 32 * max(S, 8) threads, fewer
// where a scene has fewer targets.
//
// Contract (interpolate.py three_nn, XLA branch): squared distances
// ascending, ties to the lower source index (within a slice a candidate
// displaces an entry only on strict <, and sources arrive in index order;
// the merge of the slices compares (distance, index)).
// An invalid source has distance exactly 1e10 (a select, so it still
// ranks), and a target with fewer than 3 valid sources gets invalid ones at
// 1e10, lowest index first. The Python wrapper refuses M < 3.

#include "common.cuh"

namespace {

constexpr int kMaxSplit = 32;
constexpr int kMinCtaWarps = 8;
constexpr size_t kStaticSmem = 48 * 1024;

struct Top3 {
  float d0, d1, d2;
  int i0, i1, i2;
};

// Sequential insertion: sources arrive in index order, strict < keeps the
// earlier one on a tie.
__device__ __forceinline__ void insert_in_order(Top3& k, float d, int j) {
  if (d < k.d2) {
    if (d < k.d1) {
      k.d2 = k.d1;
      k.i2 = k.i1;
      if (d < k.d0) {
        k.d1 = k.d0;
        k.i1 = k.i0;
        k.d0 = d;
        k.i0 = j;
      } else {
        k.d1 = d;
        k.i1 = j;
      }
    } else {
      k.d2 = d;
      k.i2 = j;
    }
  }
}

// the squared distance; an invalid source (flag w) ranks at exactly 1e10
template <bool kValid>
__device__ __forceinline__ float distance(float x, float y, float z, float4 p) {
  const float d = gspn::sqdist(x, y, z, p.x, p.y, p.z);
  return kValid && p.w != 0.f ? 1e10f : d;
}

__device__ __forceinline__ bool lex_less(float d, int j, float dk, int ik) {
  return d < dk || (d == dk && j < ik);
}

// Insertion by (distance, index): candidates come in any index order.
__device__ __forceinline__ void insert_lex(Top3& k, float d, int j) {
  if (lex_less(d, j, k.d2, k.i2)) {
    if (lex_less(d, j, k.d1, k.i1)) {
      k.d2 = k.d1;
      k.i2 = k.i1;
      if (lex_less(d, j, k.d0, k.i0)) {
        k.d1 = k.d0;
        k.i1 = k.i0;
        k.d0 = d;
        k.i0 = j;
      } else {
        k.d1 = d;
        k.i1 = j;
      }
    } else {
      k.d2 = d;
      k.i2 = j;
    }
  }
}

// CTA of 32 * q * split threads: warp w is slice w / q, target warp w % q;
// lane l of target warp tw owns targets first + 32 t, t < T. kGroup:
// sources compared before any insertion, a bit each.
template <int T, int kGroup, bool kValid>
__global__ void __launch_bounds__(1024) three_nn_kernel(
    const float* __restrict__ xyz1, const float* __restrict__ xyz2,
    const uint8_t* __restrict__ valid2, int n, int m, int split,
    float* __restrict__ dist, int* __restrict__ idx) {
  extern __shared__ float4 smem[];
  const int nthreads = blockDim.x;
  const int tile = 2 * nthreads;
  const int chunk = tile / split;  // a slice's sources of a tile
  const int q = nthreads / (32 * split);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slice = warp / q, tw = warp % q;
  const int b = blockIdx.y;
  const int first = (blockIdx.x * q + tw) * 32 * T + lane;
  const bool idle = first - lane >= n;  // a warp past the scene's targets

  float tx[T], ty[T], tz[T];
  Top3 top[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int j = min(first + 32 * t, n - 1);
    const float* p = xyz1 + (static_cast<size_t>(b) * n + j) * 3;
    tx[t] = p[0];
    ty[t] = p[1];
    tz[t] = p[2];
    top[t] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0, 0, 0};
  }
  const float* src = xyz2 + static_cast<size_t>(b) * m * 3;
  const uint8_t* v = kValid ? valid2 + static_cast<size_t>(b) * m : nullptr;

  // a source past m is NaN: its distance is NaN, below no threshold
  float4 pre[2];
  auto fetch = [&](int base) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = base + threadIdx.x + r * nthreads;
      pre[r] = j < m ? make_float4(src[3 * j], src[3 * j + 1], src[3 * j + 2],
                                   kValid && !v[j] ? 1.f : 0.f)
                     : make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, 0.f);
    }
  };
  auto stash = [&](float4* buf) {
#pragma unroll
    for (int r = 0; r < 2; ++r) buf[threadIdx.x + r * nthreads] = pre[r];
  };

  fetch(0);
  stash(smem);
  __syncthreads();
  for (int base = 0, k = 0; base < m; base += tile, ++k) {
    const float4* cur = smem + (k & 1) * tile;
    const bool more = base + tile < m;
    if (more) fetch(base + tile);
    const int lo = slice * chunk;
    if (idle) {
      // stages sources and meets the barriers only
    } else if constexpr (kGroup == 1) {  // few sources: each inserted as it comes
      const int hi = min(lo + chunk, m - base);
#pragma unroll 4
      for (int u = lo; u < hi; ++u) {
        const float4 p = cur[u];
#pragma unroll
        for (int t = 0; t < T; ++t)
          insert_in_order(top[t], distance<kValid>(tx[t], ty[t], tz[t], p), base + u);
      }
    } else {
      // groups of kGroup sources: a bit per source that beats the target's
      // third distance as it stood at the group's start (the threshold only
      // falls, so a source without a bit would not be inserted), then the
      // marked sources inserted in order; the padding past m never marks
      const int hi = min(lo + chunk, (m - base + kGroup - 1) / kGroup * kGroup);
      for (int g0 = lo; g0 < hi; g0 += kGroup) {
        unsigned hit[T];
#pragma unroll
        for (int t = 0; t < T; ++t) hit[t] = 0;
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const float4 p = cur[g0 + g];
#pragma unroll
          for (int t = 0; t < T; ++t)
            if (distance<kValid>(tx[t], ty[t], tz[t], p) < top[t].d2) hit[t] |= 1u << g;
        }
#pragma unroll
        for (int t = 0; t < T; ++t) {
          while (hit[t]) {
            const int g = __ffs(hit[t]) - 1;
            hit[t] &= hit[t] - 1;
            insert_in_order(top[t], distance<kValid>(tx[t], ty[t], tz[t], cur[g0 + g]),
                            base + g0 + g);
          }
        }
      }
    }
    if (more) stash(smem + ((k + 1) & 1) * tile);
    __syncthreads();
  }

  if (split > 1) {
    // partial lists of slices 1.., as [slice - 1][tw][t][6][lane]
    float* part = reinterpret_cast<float*>(smem);
    if (slice > 0) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float* o = part + ((((slice - 1) * q + tw) * T + t) * 6) * 32 + lane;
        o[0] = top[t].d0;
        o[32] = top[t].d1;
        o[64] = top[t].d2;
        o[96] = __int_as_float(top[t].i0);
        o[128] = __int_as_float(top[t].i1);
        o[160] = __int_as_float(top[t].i2);
      }
    }
    __syncthreads();
    if (slice > 0) return;
    for (int s = 1; s < split; ++s) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float* o = part + ((((s - 1) * q + tw) * T + t) * 6) * 32 + lane;
        insert_lex(top[t], o[0], __float_as_int(o[96]));
        insert_lex(top[t], o[32], __float_as_int(o[128]));
        insert_lex(top[t], o[64], __float_as_int(o[160]));
      }
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int j = first + 32 * t;
    if (j >= n) continue;
    const size_t o = (static_cast<size_t>(b) * n + j) * 3;
    dist[o] = top[t].d0;
    dist[o + 1] = top[t].d1;
    dist[o + 2] = top[t].d2;
    idx[o] = top[t].i0;
    idx[o + 1] = top[t].i1;
    idx[o + 2] = top[t].i2;
  }
}

template <int T, int kGroup, bool kValid>
int launch(const float* xyz1, const float* xyz2, const uint8_t* valid2, int nb,
           int n, int m, int split, float* dist, int* idx,
           cudaStream_t stream) {
  // target warps a CTA: enough for 8 warps in all, no more than a scene needs
  int q = split < kMinCtaWarps ? kMinCtaWarps / split : 1;
  const int scene_warps = (n + 32 * T - 1) / (32 * T);
  if (q > scene_warps) q = scene_warps;
  const int threads = 32 * q * split;
  const size_t tiles = 2 * 2 * static_cast<size_t>(threads) * sizeof(float4);
  const size_t parts = static_cast<size_t>(split - 1) * q * T * 6 * 32 * 4;
  const size_t smem = tiles > parts ? tiles : parts;
  auto kernel = three_nn_kernel<T, kGroup, kValid>;
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per_cta = 32 * T * q;
  const dim3 grid((n + per_cta - 1) / per_cta, nb);
  kernel<<<grid, threads, smem, stream>>>(xyz1, xyz2, valid2, n, m, split,
                                          dist, idx);
  return static_cast<int>(cudaGetLastError());
}

// the template instance of (targets a thread, group, validity)
template <int kGroup, bool kValid>
int launch_per(int per, const float* xyz1, const float* xyz2,
               const uint8_t* valid2, int nb, int n, int m, int split,
               float* dist, int* idx, cudaStream_t stream) {
  switch (per) {
    case 1:
      return launch<1, kGroup, kValid>(xyz1, xyz2, valid2, nb, n, m, split,
                                       dist, idx, stream);
    case 2:
      return launch<2, kGroup, kValid>(xyz1, xyz2, valid2, nb, n, m, split,
                                       dist, idx, stream);
    default:
      return launch<4, kGroup, kValid>(xyz1, xyz2, valid2, nb, n, m, split,
                                       dist, idx, stream);
  }
}

template <bool kValid>
int launch_group(int group, int per, const float* xyz1, const float* xyz2,
                 const uint8_t* valid2, int nb, int n, int m, int split,
                 float* dist, int* idx, cudaStream_t stream) {
  if (group == 1)
    return launch_per<1, kValid>(per, xyz1, xyz2, valid2, nb, n, m, split,
                                 dist, idx, stream);
  return launch_per<32, kValid>(per, xyz1, xyz2, valid2, nb, n, m, split, dist,
                                idx, stream);
}

}  // namespace

// per: targets a thread (1, 2 or 4); split: source slices (a power of 2,
// 1-32); group: sources compared before any insertion (32; 1: each source
// inserted as it comes); all from
// three_nn_plan, or forced to time one against another.
extern "C" int gspn_three_nn(const float* xyz1, const float* xyz2,
                             const uint8_t* valid2, int nb, int n, int m,
                             int per, int split, int group, float* dist,
                             int* idx, cudaStream_t stream) {
  if (nb > 65535 || m < 1 || (per != 1 && per != 2 && per != 4) ||
      split < 1 || split > kMaxSplit || (split & (split - 1)) != 0 ||
      (group != 1 && group != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0 || n == 0) return 0;
  if (valid2 != nullptr)
    return launch_group<true>(group, per, xyz1, xyz2, valid2, nb, n, m, split,
                              dist, idx, stream);
  return launch_group<false>(group, per, xyz1, xyz2, valid2, nb, n, m, split,
                             dist, idx, stream);
}
