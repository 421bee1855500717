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
// at 1 x 64 x 65536 x 64), each a squared distance and an update of the
// running (nearest distance, logit), against B*R*N*4 bytes of output. So
// the design spends as few instructions a pair as it can:
//   - A CTA projects the kRB RoIs of one scene onto kSpan = kThreads x kPts
//     scene points. A thread holds kPts points in registers (p0 + k *
//     kThreads, so a warp's stores are coalesced) and reads each sample
//     staged in shared memory (x, y, z, logit key as a broadcast float4)
//     once for its kPts points.
//   - The running (nearest distance, largest logit at it) is one 64-bit key
//     a (RoI, point), the distance's bits above the logit's key (its bits
//     in an unsigned order, complemented): distances are >= 0, so their
//     bits order as the floats do, and the least key is the nearest sample
//     and, among equally near ones, the largest logit. The update is one
//     64-bit unsigned min (two compares, two selects), 12 instructions a
//     pair with the distance, against 14 for a float compare-and-select
//     (d < dmin, d == dmin, max, two selects, min), which measured slower
//     (PERF.md section 6).
//   - Validity is folded into the coordinates: an invalid sample is staged
//     with NaN x, so its distance is NaN, whose bits lie above +inf's: its
//     key never wins. Each RoI's staged samples are padded with NaN samples
//     to a multiple of kSUnroll, so the inner loop runs unguarded.
//   - The 3e10 contract: the least key is a reduction whose order does not
//     matter, so the invalid samples, which all sit at 3e10 with no logit,
//     are one item (3e10, -1e10) applied at the end: a per-RoI flag set
//     while staging says the RoI has one, and then a point whose nearest
//     valid sample lies beyond 3e10 gets -1e10; at exactly 3e10 the tie
//     keeps the valid logit (logits are assumed above -1e10).
//   - Grid (N / kSpan, R / kRB, B): 4096 CTAs of 4 warps at both main-path
//     shapes; 59 registers a thread let 8 CTAs (32 warps) share a SM.
//     Fewer RoIs a CTA and more resident warps measured faster than
//     more RoIs and points a thread (PERF.md section 6).
// Both kernels share this routine. The boxed one first reads the relevance
// word of each of its (RoI, point) pairs, writes the -1e10 fill for the
// irrelevant ones, skips a RoI none of its points is relevant to, and a
// CTA with nothing relevant writes the fill and returns.
//
// Contract (mask_project.py nearest_sample_logit): an invalid sample sits
// at distance 3e10 and gives no logit; on equal distances the largest
// valid logit wins; no valid sample gives -1e10. The distance is
// ((dx*dx + dy*dy) + dz*dz) of p - sample in round-to-nearest intrinsics
// (gspn::sqdist), since the tie rule depends on exact equality.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // threads a CTA
constexpr int kPts = 4;        // scene points a thread
constexpr int kSpan = kThreads * kPts;  // scene points a CTA
constexpr int kRB = 2;         // RoIs a CTA
constexpr int kSChunk = 64;    // samples of each RoI staged at a time
constexpr int kSUnroll = 8;    // staged samples are padded to a multiple
constexpr float kNeg = -1e10f;
constexpr float kInvalidD2 = 3e10f;

// A logit's key: the less, the larger the logit (the bits turned into an
// unsigned order, then complemented); key_logit inverts it.
__device__ __forceinline__ unsigned logit_key(float w) {
  const unsigned u = __float_as_uint(w);
  return ~((u & 0x80000000u) ? ~u : (u | 0x80000000u));
}
__device__ __forceinline__ float key_logit(unsigned key) {
  const unsigned o = ~key;
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

template <bool kBoxed>
__global__ void __launch_bounds__(kThreads, 8)
    nearest_logit_kernel(const float* __restrict__ xyz,
                         const float* __restrict__ sampled,
                         const float* __restrict__ logits,
                         const uint8_t* __restrict__ svalid,
                         const int* __restrict__ rel, int rb, int tn, int nrb,
                         int ntiles, int n, int r, int s,
                         float* __restrict__ out) {
  __shared__ float4 samp[kRB][kSChunk];  // x (NaN where invalid), y, z, logit key
  __shared__ int has_invalid[kRB];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kRB;
  const int nr = r - r0 < kRB ? r - r0 : kRB;
  const int p0 = blockIdx.x * kSpan + threadIdx.x;
  float* orow = out + (static_cast<size_t>(b) * r + r0) * n;

  // bit q * kPts + k: point k of this thread is projected for RoI q
  unsigned live = 0;
#pragma unroll
  for (int q = 0; q < kRB; ++q) {
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      const int p = p0 + k * kThreads;
      if (q >= nr || p >= n) continue;
      if (kBoxed &&
          !rel[(static_cast<size_t>(b) * nrb + (r0 + q) / rb) * ntiles + p / tn])
        continue;
      live |= 1u << (q * kPts + k);
    }
  }
  if (kBoxed && !__syncthreads_or(live != 0)) {
    for (int q = 0; q < nr; ++q)
#pragma unroll
      for (int k = 0; k < kPts; ++k) {
        const int p = p0 + k * kThreads;
        if (p < n) orow[static_cast<size_t>(q) * n + p] = kNeg;
      }
    return;
  }

  float px[kPts], py[kPts], pz[kPts];
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    const int p = p0 + k * kThreads;
    px[k] = py[k] = pz[k] = 0.0f;
    if (p < n) {
      const float* pt = xyz + (static_cast<size_t>(b) * n + p) * 3;
      px[k] = pt[0];
      py[k] = pt[1];
      pz[k] = pt[2];
    }
  }
  // (distance bits << 32 | logit key): the least is the nearest sample and,
  // among equally near ones, the largest logit
  unsigned long long kmin[kRB][kPts];
#pragma unroll
  for (int q = 0; q < kRB; ++q)
#pragma unroll
    for (int k = 0; k < kPts; ++k)
      kmin[q][k] = (static_cast<unsigned long long>(__float_as_uint(CUDART_INF_F)) << 32) |
                   logit_key(kNeg);
  if (threadIdx.x < kRB) has_invalid[threadIdx.x] = 0;

  for (int s0 = 0; s0 < s; s0 += kSChunk) {
    const int len = s - s0 < kSChunk ? s - s0 : kSChunk;
    const int steps = (len + kSUnroll - 1) / kSUnroll * kSUnroll;
    __syncthreads();  // the last chunk is read; the flags are zeroed
    for (int e = threadIdx.x; e < kRB * kSChunk; e += kThreads) {
      const int q = e / kSChunk, u = e % kSChunk;
      if (q >= nr || u >= steps) continue;
      float4 t = make_float4(CUDART_NAN_F, 0.0f, 0.0f, 0.0f);
      if (u < len) {
        const size_t o = (static_cast<size_t>(b) * r + r0 + q) * s + s0 + u;
        const bool ok = svalid[o] != 0;
        t = make_float4(ok ? sampled[3 * o] : CUDART_NAN_F, sampled[3 * o + 1],
                        sampled[3 * o + 2], __uint_as_float(logit_key(logits[o])));
        if (!ok) has_invalid[q] = 1;
      }
      samp[q][u] = t;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRB; ++q) {
      if (q >= nr) break;
      if (((live >> (q * kPts)) & ((1u << kPts) - 1u)) == 0) continue;
      for (int u0 = 0; u0 < steps; u0 += kSUnroll) {
#pragma unroll
        for (int u = u0; u < u0 + kSUnroll; ++u) {
          const float4 t = samp[q][u];
#pragma unroll
          for (int k = 0; k < kPts; ++k) {
            const float d = gspn::sqdist(px[k], py[k], pz[k], t.x, t.y, t.z);
            const unsigned long long key =
                (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
                __float_as_uint(t.w);
            kmin[q][k] = key < kmin[q][k] ? key : kmin[q][k];
          }
        }
      }
    }
  }
  __syncthreads();  // the flags, also when there is no sample

#pragma unroll
  for (int q = 0; q < kRB; ++q) {
    if (q >= nr) break;
    const bool invalid = has_invalid[q] != 0;
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      const int p = p0 + k * kThreads;
      if (p >= n) continue;
      const bool beyond =
          invalid && __uint_as_float(static_cast<unsigned>(kmin[q][k] >> 32)) > kInvalidD2;
      orow[static_cast<size_t>(q) * n + p] = ((live >> (q * kPts + k)) & 1u) && !beyond
                                                 ? key_logit(static_cast<unsigned>(kmin[q][k]))
                                                 : kNeg;
    }
  }
}

int launch(bool boxed, const float* xyz, const float* sampled,
           const float* logits, const uint8_t* svalid, int nb, int n, int r,
           int s, const int* rel, int rb, int tn, int nrb, int ntiles,
           float* out, cudaStream_t stream) {
  const dim3 grid((n + kSpan - 1) / kSpan, (r + kRB - 1) / kRB, nb);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (grid.x > 0 && grid.y > 0 && grid.z > 0) {
    if (boxed)
      nearest_logit_kernel<true><<<grid, kThreads, 0, stream>>>(
          xyz, sampled, logits, svalid, rel, rb, tn, nrb, ntiles, n, r, s, out);
    else
      nearest_logit_kernel<false><<<grid, kThreads, 0, stream>>>(
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
