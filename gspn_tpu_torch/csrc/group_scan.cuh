// First-K grouping scan shared by the ball-group and box-group kernels.
//
// One warp per query (a ball centre, or an RoI box). The warp scans the
// scene's points in index order, 32 at a time; lane l tests point base+l.
// Per scale, __ballot_sync collects the hits of the 32 points and each
// hitting lane takes slot cnt + popc(ballot & lanes below it), so hits land
// in ascending index order: exactly the reference's serial first-come scan.
// A slot below K gets the point's index and its coordinates minus the
// query's origin. The scan stops once every scale holds K hits (the
// counterpart of the CUDA reference's per-thread `break` and of the Pallas
// kernel's early-exit while_loop). Afterwards slots past the count repeat
// the first hit (replicate-first padding); an empty row gets index 0 and
// point 0's coordinates minus the origin.
//
// What bounds it on the card: reading the scene. A query that finds K hits
// early reads only a prefix; one whose ball is sparse reads all 12*N bytes
// of the scene's coordinates (plus N validity bytes). The hit tests and
// slot arithmetic are a few instructions per point. All queries of a
// scene read the same points, so those reads hit L2 (a 65,536-point scene
// is 0.8 MB) rather than device memory.

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
  float* local[kMaxScales];  // (B, M, k, 3) f32
};

// kBox=false: query = (B, M, 3) ball centres, hit = d2 < r2[s] (strict),
//             origin = the centre.
// kBox=true:  query = (B, M, 6) boxes [lo, hi], hit = lo <= p <= hi
//             (inclusive, one scale), origin = (lo + hi) * 0.5.
template <bool kBox>
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

  float ox, oy, oz;                  // origin of the local frame
  float lx = 0, ly = 0, lz = 0;      // box lo
  float hx = 0, hy = 0, hz = 0;      // box hi
  if (kBox) {
    const float* bx = query + static_cast<size_t>(q) * 6;
    lx = bx[0]; ly = bx[1]; lz = bx[2];
    hx = bx[3]; hy = bx[4]; hz = bx[5];
    ox = __fmul_rn(__fadd_rn(lx, hx), 0.5f);
    oy = __fmul_rn(__fadd_rn(ly, hy), 0.5f);
    oz = __fmul_rn(__fadd_rn(lz, hz), 0.5f);
  } else {
    const float* c = query + static_cast<size_t>(q) * 3;
    ox = c[0]; oy = c[1]; oz = c[2];
  }

  int cnt[kMaxScales];
  int first[kMaxScales];
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    cnt[s] = 0;
    first[s] = 0;
  }
  const unsigned below = (1u << lane) - 1u;

  for (int base = 0; base < n; base += 32) {
    bool done = true;
#pragma unroll
    for (int s = 0; s < kMaxScales; ++s)
      if (s < out.nscales && cnt[s] < out.k[s]) done = false;
    if (done) break;

    const int j = base + lane;
    float px = 0, py = 0, pz = 0;
    bool ok = false;
    if (j < n) {
      px = pts[3 * j];
      py = pts[3 * j + 1];
      pz = pts[3 * j + 2];
      ok = v == nullptr || v[j] != 0;
    }
    float d2 = 0;
    if (kBox) {
      ok = ok && px >= lx && px <= hx && py >= ly && py <= hy && pz >= lz &&
           pz <= hz;
    } else {
      d2 = sqdist(ox, oy, oz, px, py, pz);
    }
#pragma unroll
    for (int s = 0; s < kMaxScales; ++s) {
      if (s >= out.nscales) break;
      const bool hit = kBox ? ok : (ok && d2 < out.r2[s]);
      const unsigned bal = __ballot_sync(kFullMask, hit);
      if (bal == 0) continue;
      const int c = cnt[s];
      if (c == 0) first[s] = base + __ffs(bal) - 1;
      const int slot = c + __popc(bal & below);
      if (hit && slot < out.k[s]) {
        const size_t o = static_cast<size_t>(q) * out.k[s] + slot;
        out.idx[s][o] = j;
        out.local[s][3 * o] = __fsub_rn(px, ox);
        out.local[s][3 * o + 1] = __fsub_rn(py, oy);
        out.local[s][3 * o + 2] = __fsub_rn(pz, oz);
      }
      cnt[s] = c + __popc(bal);
    }
  }

#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s >= out.nscales) break;
    const int k = out.k[s];
    const int c = cnt[s] < k ? cnt[s] : k;
    // padding repeats the first hit; an empty row takes point 0
    const int fill = c > 0 ? first[s] : 0;
    const float fx = __fsub_rn(pts[3 * fill], ox);
    const float fy = __fsub_rn(pts[3 * fill + 1], oy);
    const float fz = __fsub_rn(pts[3 * fill + 2], oz);
    for (int slot = c + lane; slot < k; slot += 32) {
      const size_t o = static_cast<size_t>(q) * k + slot;
      out.idx[s][o] = fill;
      out.local[s][3 * o] = fx;
      out.local[s][3 * o + 1] = fy;
      out.local[s][3 * o + 2] = fz;
    }
    if (lane == 0) out.cnt[s][q] = c;
  }
}

template <bool kBox>
int launch_group_scan(const float* xyz, const uint8_t* valid,
                      const float* query, int nb, int n, int m,
                      const GroupOut& out, cudaStream_t stream) {
  constexpr int kWarpsPerBlock = 4;
  const long long warps = static_cast<long long>(nb) * m;
  const int blocks =
      static_cast<int>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (blocks > 0)
    group_scan_kernel<kBox><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
        xyz, valid, query, nb, n, m, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gspn
