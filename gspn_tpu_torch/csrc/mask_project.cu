// RoI-mask projection: for each RoI and scene point, the mask logit of the
// RoI's nearest valid sample.
//
// Replaces gspn_tpu/ops/mask_project.py::_mask_project_kernel and
// ::_mask_project_boxed_kernel, the Pallas kernels that build an (RoI block
// x samples x 2048-point tile) distance tensor in VMEM and reduce it to the
// nearest sample's logit; the boxed one writes the -1e10 fill for (RoI
// block, tile) programs that its relevance table marks 0.
//
// What bounds it on the card: the pair count, B*R*N*S distance evaluations
// (about 268 M per request at 8 x 64 RoIs x 8192 points x 64 samples, and
// at 1 x 64 x 65536 x 64), against B*R*N*4 bytes of output. Design: one
// thread per scene point, a block stages the samples of kRB RoIs in shared
// memory (x, y, z, logit as a float4 and the validity byte, kSChunk at a
// time), every thread runs over them from shared memory (broadcast reads)
// keeping (dmin, best logit) per RoI in registers, and writes kRB coalesced
// rows of out[b, r, :]. Both kernels share this tile routine; the boxed one
// reads its relevance words first and skips the pruned (RoI, tile) pairs,
// and a block with nothing relevant writes the fill and returns.
//
// Contract (mask_project.py nearest_sample_logit): an invalid sample sits
// at distance 3e10 and gives no logit; on equal distances the largest
// valid logit wins; no valid sample gives -1e10. The distance is
// ((dx*dx + dy*dy) + dz*dz) of p - sample in round-to-nearest intrinsics
// (gspn::sqdist), since the tie rule depends on exact equality.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // scene points per block
constexpr int kRB = 8;         // RoIs per block
constexpr int kSChunk = 64;    // samples of each RoI staged at a time
constexpr float kNeg = -1e10f;
constexpr float kInvalidD2 = 3e10f;

template <bool kBoxed>
__global__ void __launch_bounds__(kThreads)
    mask_project_kernel(const float* __restrict__ xyz,
                        const float* __restrict__ sampled,
                        const float* __restrict__ logits,
                        const uint8_t* __restrict__ svalid,
                        const int* __restrict__ rel, int rb, int tn, int nrb,
                        int ntiles, int n, int r, int s,
                        float* __restrict__ out) {
  __shared__ float4 samp[kRB][kSChunk];  // x, y, z, logit
  __shared__ uint8_t sval[kRB][kSChunk];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kRB;
  const int nr = r - r0 < kRB ? r - r0 : kRB;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool active = p < n;
  float* orow = out + (static_cast<size_t>(b) * r + r0) * n + p;

  unsigned live = (1u << nr) - 1;  // the RoIs this thread projects
  if (kBoxed) {
    live = 0;
    if (active) {
      const int* row = rel + static_cast<size_t>(b) * nrb * ntiles + p / tn;
      for (int q = 0; q < nr; ++q)
        if (row[static_cast<size_t>((r0 + q) / rb) * ntiles]) live |= 1u << q;
    }
    if (!__syncthreads_or(live != 0)) {
      if (active)
        for (int q = 0; q < nr; ++q) orow[static_cast<size_t>(q) * n] = kNeg;
      return;
    }
  }

  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (active) {
    const float* pt = xyz + (static_cast<size_t>(b) * n + p) * 3;
    px = pt[0];
    py = pt[1];
    pz = pt[2];
  }
  float dmin[kRB], best[kRB];
#pragma unroll
  for (int q = 0; q < kRB; ++q) {
    dmin[q] = CUDART_INF_F;
    best[q] = kNeg;
  }
  for (int s0 = 0; s0 < s; s0 += kSChunk) {
    const int len = s - s0 < kSChunk ? s - s0 : kSChunk;
    __syncthreads();
    for (int e = threadIdx.x; e < kRB * kSChunk; e += kThreads) {
      const int q = e / kSChunk, u = e % kSChunk;
      if (q < nr && u < len) {
        const size_t o = (static_cast<size_t>(b) * r + r0 + q) * s + s0 + u;
        samp[q][u] = make_float4(sampled[3 * o], sampled[3 * o + 1],
                                 sampled[3 * o + 2], logits[o]);
        sval[q][u] = svalid[o];
      }
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int q = 0; q < kRB; ++q) {
      if (!((live >> q) & 1u)) continue;
      for (int u = 0; u < len; ++u) {
        const float4 t = samp[q][u];
        const bool v = sval[q][u] != 0;
        const float d = v ? gspn::sqdist(px, py, pz, t.x, t.y, t.z) : kInvalidD2;
        if (d < dmin[q]) {
          dmin[q] = d;
          best[q] = v ? t.w : kNeg;
        } else if (d == dmin[q] && v) {
          best[q] = fmaxf(best[q], t.w);
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int q = 0; q < kRB; ++q)
      if (q < nr) orow[static_cast<size_t>(q) * n] = ((live >> q) & 1u) ? best[q] : kNeg;
  }
}

int launch(bool boxed, const float* xyz, const float* sampled,
           const float* logits, const uint8_t* svalid, int nb, int n, int r,
           int s, const int* rel, int rb, int tn, int nrb, int ntiles,
           float* out, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, (r + kRB - 1) / kRB, nb);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (grid.x > 0 && grid.y > 0 && grid.z > 0) {
    if (boxed)
      mask_project_kernel<true><<<grid, kThreads, 0, stream>>>(
          xyz, sampled, logits, svalid, rel, rb, tn, nrb, ntiles, n, r, s, out);
    else
      mask_project_kernel<false><<<grid, kThreads, 0, stream>>>(
          xyz, sampled, logits, svalid, nullptr, 1, 1, 0, 0, n, r, s, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gspn_mask_project(const float* xyz, const float* sampled,
                                 const float* logits, const uint8_t* svalid,
                                 int nb, int n, int r, int s, float* out,
                                 cudaStream_t stream) {
  return launch(false, xyz, sampled, logits, svalid, nb, n, r, s, nullptr, 1, 1,
                0, 0, out, stream);
}

extern "C" int gspn_mask_project_boxed(const float* xyz, const float* sampled,
                                       const float* logits,
                                       const uint8_t* svalid, int nb, int n,
                                       int r, int s, const int* rel, int rb,
                                       int tn, int nrb, int ntiles, float* out,
                                       cudaStream_t stream) {
  if (rb <= 0 || tn <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(true, xyz, sampled, logits, svalid, nb, n, r, s, rel, rb, tn,
                nrb, ntiles, out, stream);
}
