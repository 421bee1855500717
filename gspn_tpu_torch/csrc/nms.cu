// Greedy 3D NMS: the score sort, the IoU and the suppression in one launch.
//
// Replaces gspn_tpu/ops/nms.py::_nms_kernel, the Pallas kernel that runs
// the sequential greedy loop for one scene inside VMEM (grid (B,)) over a
// score-sorted IoU matrix that XLA builds around it: for i in order,
// keep[i] = alive[i]; a kept i clears alive[j] for every later j with
// iou[i][j] > thresh.
//
// What bounds it on the card: R*R/2 IoUs (about 20 float operations each)
// and R dependent steps, which are latency, not bytes or operations. Around
// a 64-box kernel the work is a few microseconds, so the launches around it
// cost more than the kernel: the whole of nms_3d_batched is this one launch.
// Design, grid (CTAs, B):
// 1. Order. Up to kSortMax boxes, each CTA ranks the scene's boxes itself:
//    rank = #(key, index) below its own, the key an order-preserving map of
//    -score (invalid boxes at -inf, -0 and 0 one key, NaN last), which is
//    torch.sort(-s, stable=True)'s order and jnp.argsort(-s)'s. Above that
//    the wrapper sorts and passes the order in.
// 2. Suppression bitmask. Bit j of sorted row i: j > i and IoU > thresh,
//    the IoU bitwise box_iou's (NaN-propagating max / min / clamp, round-to-
//    nearest products in its order, a true division where the boxes
//    meet). A warp takes a (row, 64-bit word) at a time, a
//    lane two columns of it, the word from two ballots; row and column
//    boxes come from shared memory. Up to kOneCtaR boxes one CTA holds the
//    mask in shared memory; above, each CTA computes kCtaRows rows into a
//    device buffer and the last CTA of the scene to finish (an atomic
//    count) goes on.
// 3. Greedy sweep, 64 rows a step: one warp holds the rows' diagonal words
//    and sets keep[i] = alive[i] && !removed[i] in order (a shuffle a row,
//    no barrier); then the whole CTA ORs the kept rows' later words into
//    `removed` (ceil(R / 64) words of dynamic shared memory), every load of
//    the step at once. Exactly the sequential loop.
// 4. keep written at each box's original position.

#include "common.cuh"

// the kernels live in gspn:: (their names carry it, so that a sanitizer or
// profiler can pick them out); the C entry points below use them unqualified
using namespace gspn;

namespace gspn {
namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSortMax = 1024;      // boxes ranked inside the kernel
constexpr int kOneCtaR = 128;       // boxes one CTA takes, mask in shared memory
constexpr int kCtaRows = 16;        // mask rows a CTA computes above that
constexpr int kColChunk = 512;      // column boxes staged a pass
constexpr int kChunkWords = kColChunk / 64;
constexpr int kMaxR = 131072;       // the wrapper's MAX_R
// the sweep's suppressed bits, a word a 64 sorted boxes, live in dynamic
// shared memory (16 KB at kMaxR); beside the 34 KB of static arrays, more
// than 4 KB of them (R above 32,768) passes the 48 KB a launch may take
// without asking
constexpr size_t kUnaskedRemovedBytes = 4096;

// torch.maximum / torch.minimum: NaN in either operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// box_volume: the clamped extents' product, ((e0 * e1) * e2)
__device__ __forceinline__ float volume(float4 lo, float4 hi) {
  const float e0 = clamp_min(__fsub_rn(hi.x, lo.x), 0.f);
  const float e1 = clamp_min(__fsub_rn(hi.y, lo.y), 0.f);
  const float e2 = clamp_min(__fsub_rn(hi.z, lo.z), 0.f);
  return __fmul_rn(__fmul_rn(e0, e1), e2);
}

// box_iou(a, b) > thresh as box_iou computes it (lo.w holds the box's
// volume). A zero intersection gives 0 / union, never above a threshold
// that is not negative, so the division (whose slow path a zero dividend
// takes) runs only for boxes that meet.
__device__ __forceinline__ bool iou_above(float4 alo, float4 ahi, float4 blo,
                                          float4 bhi, float thresh) {
  const float e0 = clamp_min(
      __fsub_rn(min_nan(ahi.x, bhi.x), max_nan(alo.x, blo.x)), 0.f);
  const float e1 = clamp_min(
      __fsub_rn(min_nan(ahi.y, bhi.y), max_nan(alo.y, blo.y)), 0.f);
  const float e2 = clamp_min(
      __fsub_rn(min_nan(ahi.z, bhi.z), max_nan(alo.z, blo.z)), 0.f);
  const float inter = __fmul_rn(__fmul_rn(e0, e1), e2);
  if (inter == 0.f && thresh >= 0.f) return false;
  const float uni = clamp_min(__fsub_rn(__fadd_rn(alo.w, blo.w), inter), 1e-12f);
  return __fdiv_rn(inter, uni) > thresh;
}

// ascending key = descending score; -0 and 0 one key; NaN above +inf
__device__ __forceinline__ unsigned order_key(float s) {
  if (s != s) return 0xffffffffu;
  const unsigned u = __float_as_uint(__fadd_rn(-s, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void load_box(const float* boxes, int o, float4& lo,
                                         float4& hi) {
  const float* p = boxes + static_cast<size_t>(o) * 6;
  lo = make_float4(p[0], p[1], p[2], 0.f);
  hi = make_float4(p[3], p[4], p[5], 0.f);
  lo.w = volume(lo, hi);
}

__global__ void __launch_bounds__(kThreads) nms_kernel(
    const float* __restrict__ boxes_all, const float* __restrict__ scores,
    const uint8_t* __restrict__ valid, const int64_t* __restrict__ order_in,
    int r, float thresh, u64* __restrict__ mask_g, int* __restrict__ counter,
    uint8_t* __restrict__ keep) {
  __shared__ u64 key_s[kSortMax];
  __shared__ int order_s[kSortMax];
  __shared__ float4 col_lo[kColChunk];
  __shared__ float4 col_hi[kColChunk];
  __shared__ float4 row_lo[kOneCtaR];
  __shared__ float4 row_hi[kOneCtaR];
  __shared__ u64 mask_s[kOneCtaR * (kOneCtaR / 64)];
  extern __shared__ u64 removed_s[];  // ceil(r / 64) words
  __shared__ u64 kept_s;
  __shared__ int last_s;

  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool one_cta = gridDim.x == 1;
  const int words = (r + 63) / 64;
  const size_t sb = static_cast<size_t>(b) * r;
  const float* boxes = boxes_all + sb * 6;
  const uint8_t* vb = valid ? valid + sb : nullptr;

  // 1. order: sorted position -> original index
  if (order_in == nullptr) {
    for (int i = tid; i < r; i += kThreads) {
      const float s = (vb && !vb[i]) ? -CUDART_INF_F : scores[sb + i];
      key_s[i] = (static_cast<u64>(order_key(s)) << 32) | static_cast<unsigned>(i);
    }
    __syncthreads();
    for (int i = tid; i < r; i += kThreads) {
      const u64 k = key_s[i];
      int rank = 0;
      for (int j = 0; j < r; ++j) rank += key_s[j] < k;
      order_s[rank] = i;
    }
    __syncthreads();
  }
  auto orig = [&](int p) {
    return order_in ? static_cast<int>(order_in[sb + p]) : order_s[p];
  };

  // 2. the mask rows of this CTA (every row of a one-CTA scene, else
  // kCtaRows), a warp a (row, word) at a time, a lane two columns of it
  const int row0 = one_cta ? 0 : blockIdx.x * kCtaRows;
  const int nrows = one_cta ? r : min(kCtaRows, r - row0);
  for (int i = tid; i < nrows; i += kThreads)
    load_box(boxes, orig(row0 + i), row_lo[i], row_hi[i]);
  for (int c0 = row0 / 64 * 64; c0 < r; c0 += kColChunk) {
    __syncthreads();  // the previous chunk's boxes are no longer read
    for (int c = tid; c < kColChunk && c0 + c < r; c += kThreads)
      load_box(boxes, orig(c0 + c), col_lo[c], col_hi[c]);
    __syncthreads();
    const int w0 = c0 / 64;
    const int wn = min(kChunkWords, words - w0);
    // word-major, so that the rows of a word spread over the warps
    for (int item = warp; item < nrows * wn; item += kWarps) {
      const int i = item % nrows, w = w0 + item / nrows;
      const int p = row0 + i;
      if (w < p / 64) continue;  // the row has no bit there
      const float4 alo = row_lo[i], ahi = row_hi[i];
      const int j = 64 * w + lane;
      const bool lo_bit = j > p && j < r &&
                          iou_above(alo, ahi, col_lo[j - c0], col_hi[j - c0], thresh);
      const bool hi_bit = j + 32 > p && j + 32 < r &&
                          iou_above(alo, ahi, col_lo[j + 32 - c0], col_hi[j + 32 - c0], thresh);
      const u64 bits = static_cast<u64>(__ballot_sync(gspn::kFullMask, lo_bit)) |
                       (static_cast<u64>(__ballot_sync(gspn::kFullMask, hi_bit)) << 32);
      if (lane == 0) {
        if (one_cta)
          mask_s[p * words + w] = bits;
        else
          mask_g[(sb + p) * words + w] = bits;
      }
    }
  }

  // the scene's last CTA to finish sweeps
  if (!one_cta) {
    __threadfence();
    __syncthreads();
    if (tid == 0) last_s = atomicAdd(counter + b, 1) == static_cast<int>(gridDim.x) - 1;
    __syncthreads();
    if (!last_s) return;
    __threadfence();
  } else {
    __syncthreads();
  }
  // 3. the greedy sweep over blocks of 64 sorted rows: warp 0 decides a
  // block's rows in order, then every thread ORs the kept rows' later words
  // into `removed` (a thread a later word and a quarter of the rows, its
  // loads issued together)
  auto word = [&](int p, int w) -> u64 {
    return one_cta ? mask_s[p * words + w] : __ldcg(mask_g + (sb + p) * words + w);
  };
  for (int w = tid; w < words; w += kThreads) removed_s[w] = 0;
  __syncthreads();
  for (int k = 0; k < words; ++k) {
    if (warp == 0) {
      const int p0 = 64 * k + lane, p1 = p0 + 32;
      const int o0 = p0 < r ? orig(p0) : 0, o1 = p1 < r ? orig(p1) : 0;
      const u64 d0 = p0 < r ? word(p0, k) : 0, d1 = p1 < r ? word(p1, k) : 0;
      const bool a0 = p0 < r && (!vb || vb[o0]), a1 = p1 < r && (!vb || vb[o1]);
      const u64 alive = static_cast<u64>(__ballot_sync(gspn::kFullMask, a0)) |
                        (static_cast<u64>(__ballot_sync(gspn::kFullMask, a1)) << 32);
      u64 rem = removed_s[k], kept = 0;
#pragma unroll 8
      for (int i = 0; i < 64; ++i) {
        const u64 di = __shfl_sync(gspn::kFullMask, i < 32 ? d0 : d1, i & 31);
        if (((alive >> i) & 1) && !((rem >> i) & 1)) {
          kept |= 1ull << i;
          rem |= di;
        }
      }
      // 4. keep at each box's original position
      if (p0 < r) keep[sb + o0] = (kept >> lane) & 1;
      if (p1 < r) keep[sb + o1] = (kept >> (lane + 32)) & 1;
      if (lane == 0) kept_s = kept;
    }
    __syncthreads();
    const u64 kept = kept_s;
    const int quarter = tid / 64;
    for (int w = k + 1 + tid % 64; kept && w < words; w += 64) {
      u64 acc = 0;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int bit = quarter + 4 * c;
        if ((kept >> bit) & 1) acc |= word(64 * k + bit, w);
      }
      if (acc) atomicOr(removed_s + w, acc);
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace gspn

// boxes (nb, r, 6), scores (nb, r), valid (nb, r) bytes or null; order
// (nb, r) int64, the stable descending order of the scores with invalid
// boxes at -inf, or null to rank inside the kernel (r <= kSortMax); mask
// (nb, r, ceil(r / 64)) and counter (nb,) zeroed, scratch for r > kOneCtaR
// (else null); keep (nb, r) bytes in the original order.
extern "C" int gspn_nms(const float* boxes, const float* scores,
                        const uint8_t* valid, const int64_t* order, int nb,
                        int r, float thresh, u64* mask, int* counter,
                        uint8_t* keep, cudaStream_t stream) {
  if (r < 1 || r > kMaxR || nb > 65535 || (order == nullptr && r > kSortMax))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ctas = r <= kOneCtaR ? 1 : (r + kCtaRows - 1) / kCtaRows;
  if (ctas > 1 && (mask == nullptr || counter == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t removed_bytes = static_cast<size_t>((r + 63) / 64) * sizeof(u64);
  if (removed_bytes > kUnaskedRemovedBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(removed_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (nb > 0)
    nms_kernel<<<dim3(ctas, nb), kThreads, removed_bytes, stream>>>(
        boxes, scores, valid, order, r, thresh, mask, counter, keep);
  return static_cast<int>(cudaGetLastError());
}
