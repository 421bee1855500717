// The ball queries' scan (first-K or strided selection, indices and
// counts only; ball_query.cu), and the output record of every grouping
// kernel (GroupOut). The ball and box groups run group_first.cuh and
// group_strided.cuh.
//
// One warp per query (a ball centre). The warp scans the scene's points in
// index order, 32 at a time; lane l tests point base+l. Per scale,
// __ballot_sync collects the hits of the 32 points and each hitting lane
// takes rank cnt + popc(ballot & lanes below it), so ranks follow
// ascending index order: exactly the reference's serial first-come scan.
//
// First-K (kStrided=false): rank r < K fills slot r. The scan stops once
// every scale holds K hits (the counterpart of the CUDA reference's
// per-thread `break` and of the Pallas kernel's early-exit while_loop).
//
// Strided (kStrided=true, the JAX package's select="strided"): slot j holds
// the hit of rank floor(j * total / K), a systematic sample of the whole
// ascending hit list, where `total` is the uncapped hit count. So the scan
// runs twice: pass 1 counts `total` per scale over the whole scene (no
// early exit), pass 2 ranks the hits again and a hit of rank r is a target
// when j = ceil(r * K / total) satisfies j * total < r * K + K and j < K
// (gspn_tpu/ops/ball_query.py _strided_target_mask); it writes slot j.
// When total <= K every hit is a target, in slot r: exactly first-K. Pass 2
// stops after the last target rank of every scale. The arithmetic is in 64
// bits; it equals the JAX package's int32 arithmetic wherever that does not
// overflow (N <= 65,536 with K <= 256 does not).
//
// A slot gets the point's index. Afterwards slots past the capped count
// repeat the first hit (replicate-first padding; in strided mode rank 0 is
// always slot 0); an empty row gets index 0.
//
// What bounds it on the card: reading the scene. A first-K query that finds
// K hits early reads only a prefix; one whose ball is sparse, and every
// strided query, reads all 12*N bytes of the scene's coordinates (plus N
// validity bytes), strided twice. The hit tests and slot arithmetic are a
// few instructions per point. All queries of a scene read the same points,
// so those reads hit L2 (a 65,536-point scene is 0.8 MB) rather than device
// memory. With one warp per query a launch over few queries (64 GSPN seeds
// per scene) holds few warps per SM.

#pragma once

#include "common.cuh"

namespace gspn {

constexpr int kMaxScales = 4;

struct GroupOut {
  int nscales;
  int k[kMaxScales];
  float r2[kMaxScales];
  int* idx[kMaxScales];    // (B, M, k) int32
  int* cnt[kMaxScales];    // (B, M) int32, capped at k
  float* local[kMaxScales];  // (B, M, k, 3) f32; the ball and box groups'
};

// The slot of the hit of rank r under strided selection, or -1 when that
// rank is not sampled.
__device__ __forceinline__ int strided_slot(int r, int total, int k) {
  if (total <= k) return r;
  const long long rk = static_cast<long long>(r) * k;
  const long long j = (rk + total - 1) / total;
  return (j * total < rk + k && j < k) ? static_cast<int>(j) : -1;
}

// query = (B, M, 3) ball centres, hit = d2 < r2[s] (strict); writes (idx,
// cnt) per scale.
template <bool kStrided>
__global__ void group_scan_kernel(const float* __restrict__ xyz,
                                  const uint8_t* __restrict__ valid,
                                  const float* __restrict__ query, int nb,
                                  int n, int m, GroupOut out) {
  const int q = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= nb * m) return;  // whole warps only: q is warp-uniform
  const int b = q / m;
  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  const uint8_t* v = valid ? valid + static_cast<size_t>(b) * n : nullptr;
  const float* c = query + static_cast<size_t>(q) * 3;
  const float ox = c[0], oy = c[1], oz = c[2];

  int cnt[kMaxScales];    // hits ranked so far
  int first[kMaxScales];  // index of the first hit
  int total[kMaxScales];  // strided: uncapped hit count (pass 1)
  int last[kMaxScales];   // the last rank that fills a slot
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    cnt[s] = 0;
    first[s] = 0;
    total[s] = 0;
    last[s] = s < out.nscales ? out.k[s] - 1 : -1;
  }
  const unsigned below = (1u << lane) - 1u;

  if (kStrided) {  // pass 1: count every hit
    for (int base = 0; base < n; base += 32) {
      const int j = base + lane;
      bool ok = false;
      float d2 = 0;
      if (j < n) {
        ok = v == nullptr || v[j] != 0;
        d2 = sqdist(ox, oy, oz, pts[3 * j], pts[3 * j + 1], pts[3 * j + 2]);
      }
#pragma unroll
      for (int s = 0; s < kMaxScales; ++s) {
        if (s >= out.nscales) break;
        total[s] += __popc(__ballot_sync(kFullMask, ok && d2 < out.r2[s]));
      }
    }
#pragma unroll
    for (int s = 0; s < kMaxScales; ++s) {
      if (s >= out.nscales) break;
      const int k = out.k[s];
      last[s] = total[s] <= k
                    ? total[s] - 1
                    : static_cast<int>(static_cast<long long>(k - 1) *
                                       total[s] / k);
    }
  }

  // the first-K scan, or strided pass 2
  for (int base = 0; base < n; base += 32) {
    bool done = true;
#pragma unroll
    for (int s = 0; s < kMaxScales; ++s)
      if (s < out.nscales && cnt[s] <= last[s]) done = false;
    if (done) break;

    const int j = base + lane;
    bool ok = false;
    float d2 = 0;
    if (j < n) {
      ok = v == nullptr || v[j] != 0;
      d2 = sqdist(ox, oy, oz, pts[3 * j], pts[3 * j + 1], pts[3 * j + 2]);
    }
#pragma unroll
    for (int s = 0; s < kMaxScales; ++s) {
      if (s >= out.nscales) break;
      const bool hit = ok && d2 < out.r2[s];
      const unsigned bal = __ballot_sync(kFullMask, hit);
      if (bal == 0) continue;
      const int c0 = cnt[s];
      if (c0 == 0) first[s] = base + __ffs(bal) - 1;
      const int rank = c0 + __popc(bal & below);
      const int slot = kStrided ? strided_slot(rank, total[s], out.k[s]) : rank;
      if (hit && slot >= 0 && slot < out.k[s])
        out.idx[s][static_cast<size_t>(q) * out.k[s] + slot] = j;
      cnt[s] = c0 + __popc(bal);
    }
  }

#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s >= out.nscales) break;
    const int k = out.k[s];
    const int hits = kStrided ? total[s] : cnt[s];
    const int c = hits < k ? hits : k;
    // padding repeats the first hit; an empty row takes point 0
    const int fill = c > 0 ? first[s] : 0;
    for (int slot = c + lane; slot < k; slot += 32)
      out.idx[s][static_cast<size_t>(q) * k + slot] = fill;
    if (lane == 0) out.cnt[s][q] = c;
  }
}

template <bool kStrided>
int launch_group_scan(const float* xyz, const uint8_t* valid,
                      const float* query, int nb, int n, int m,
                      const GroupOut& out, cudaStream_t stream) {
  constexpr int kWarpsPerBlock = 4;
  const long long warps = static_cast<long long>(nb) * m;
  const int blocks =
      static_cast<int>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (blocks > 0)
    group_scan_kernel<kStrided><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
        xyz, valid, query, nb, n, m, out);
  return static_cast<int>(cudaGetLastError());
}

// GroupOut for the ball scans from the C entry points' per-scale arrays
// (local may be null for the index-only scan).
inline int ball_group_out(int nscales, const float* r2s, const int* ks,
                          int* const* idx, int* const* cnt,
                          float* const* local, GroupOut* out) {
  if (nscales < 1 || nscales > kMaxScales)
    return static_cast<int>(cudaErrorInvalidValue);
  *out = GroupOut{};
  out->nscales = nscales;
  for (int s = 0; s < nscales; ++s) {
    out->k[s] = ks[s];
    out->r2[s] = r2s[s];
    out->idx[s] = idx[s];
    out->cnt[s] = cnt[s];
    out->local[s] = local ? local[s] : nullptr;
  }
  return 0;
}

}  // namespace gspn
