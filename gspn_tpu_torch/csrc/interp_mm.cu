// Inverse-distance interpolation of three source rows per target, with the
// FP module's weights and skip concat in the same launch:
//   out[b, n, :C] = sum_k w[b, n, k] * points[b, idx[b, n, k], :]
//   out[b, n, C:] = skip[b, n, :]             (C1 skip channels, or none)
// where w is given, or computed from three_nn's squared distances as
// interpolate.py three_interpolate_weights does.
//
// Replaces gspn_tpu/ops/interpolate.py::_interp_mm_kernel, the Pallas kernel
// that writes each target row's three weights into a sparse (targets x
// sources) tile and multiplies it with the source block on the MXU: a way
// to gather on a TPU. Here the gather is a gather, with no bound on the
// source block.
//
// What bounds it on the card: bytes. Each target reads three source rows
// (at most 1024 x 512 floats of sources per scene on the slice, resident in
// L2), its indices and distances, its skip row, and writes one row; at FP4
// the write alone is 8 x 8192 x 128 x 4 B, and gathering three source rows
// a target moves 100 MB through L2, which held the first design at the
// L2's rate (0.019 ms), not the device memory's. Two forms, one launch
// each; interpolate.py interp_mm_plan picks the form and its tiling:
// - Direct (FP1-FP3, any shape): a warp takes a task, up to 8 target rows
//   (lane 3r + k loads row r's neighbour k, index and distance, once; the
//   weights are computed in those lanes and handed to the whole warp by
//   shuffle) and one slice of their output columns, about 2048 tasks a
//   launch. Lanes walk the columns four at a time (16-byte loads and
//   stores) where the rows' addresses and widths allow, and one at a time
//   where they do not (the interpolated and the skip part decide apart).
// - Staged (FP4: many rows a scene, no skip, C a multiple of 32): a CTA a
//   (scene, slice of 32 channels, chunk of up to 2048 rows) copies the
//   scene's slice of sources into shared memory by cp.async, computes its
//   rows' weights meanwhile, then gathers from shared memory: each source
//   row leaves L2 once a CTA, not three times a target, and the launch is
//   bound by its writes.
// The output is written with streaming stores (st.global.cs), and the skip
// rows, indices and distances read with streaming loads, so that they do
// not evict the source rows from L2.
//
// Numerics, bitwise interpolate.py three_interpolate_fp's plain version
// (with -fmad=false and round-to-nearest intrinsics, never contracted):
//   d_k = dist_k < 1e-10 ? 1e-10 : dist_k    (torch.clamp: NaN stays NaN)
//   r_k = 1 / d_k  (a true division),  s = (r_0 + r_1) + r_2,  w_k = r_k / s
//   out = (p_0*w_0 + p_1*w_1) + p_2*w_2       (neighbour order)
// which is also the JAX package's exact interpolation, within 1-2 ulp of the
// TPU's source-ordered matmul sum.

#include "common.cuh"

// the kernels live in gspn:: (their names carry it, so that a sanitizer or
// profiler can pick them out); the C entry points below use them unqualified
using namespace gspn;

namespace gspn {
namespace {

constexpr int kWarps = 8;        // tasks a CTA
constexpr int kMaxRows = 8;      // rows a task: their 3 neighbours fill 24 lanes
constexpr int kSliceUnit = 128;  // slice widths are multiples of a warp's float4s
constexpr float kEps = 1e-10f;   // three_interpolate_weights' eps in float32

__device__ __forceinline__ float interp1(float a, float b, float c, float w0,
                                         float w1, float w2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, w0), __fmul_rn(b, w1)),
                   __fmul_rn(c, w2));
}

__global__ void __launch_bounds__(kWarps * 32) interp_mm_kernel(
    const float* __restrict__ points, const int* __restrict__ idx,
    const float* __restrict__ wd, bool from_dist,
    const float* __restrict__ skip, long rows, int n, int m, int c, int c1,
    int per_task, int slices, int slice_w, bool vec_interp, bool vec_skip,
    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long task = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long first = task / slices * per_task;
  if (first >= rows) return;
  const int nrows = static_cast<int>(min(static_cast<long>(per_task), rows - first));
  const int ctot = c + c1;
  const int lo = static_cast<int>(task % slices) * slice_w;
  const int hi = min(lo + slice_w, ctot);

  // lane 3r + k: neighbour k of row first + r
  int iv = 0;
  float w = 1.f;
  if (lane < 3 * nrows) {
    iv = __ldcs(idx + first * 3 + lane);
    w = __ldcs(wd + first * 3 + lane);
  }
  if (from_dist) {
    const float d = w < kEps ? kEps : w;
    const float r = __fdiv_rn(1.f, d);
    const int r0 = lane / 3 * 3;
    const float s = __fadd_rn(
        __fadd_rn(__shfl_sync(gspn::kFullMask, r, r0),
                  __shfl_sync(gspn::kFullMask, r, r0 + 1)),
        __shfl_sync(gspn::kFullMask, r, r0 + 2));
    w = __fdiv_rn(r, s);
  }

  for (int t = 0; t < nrows; ++t) {
    const long row = first + t;
    const int i0 = __shfl_sync(gspn::kFullMask, iv, 3 * t);
    const int i1 = __shfl_sync(gspn::kFullMask, iv, 3 * t + 1);
    const int i2 = __shfl_sync(gspn::kFullMask, iv, 3 * t + 2);
    const float w0 = __shfl_sync(gspn::kFullMask, w, 3 * t);
    const float w1 = __shfl_sync(gspn::kFullMask, w, 3 * t + 1);
    const float w2 = __shfl_sync(gspn::kFullMask, w, 3 * t + 2);
    const float* base = points + row / n * m * c;
    const float* p0 = base + static_cast<long>(i0) * c;
    const float* p1 = base + static_cast<long>(i1) * c;
    const float* p2 = base + static_cast<long>(i2) * c;
    float* o = out + row * ctot;
    const int ih = min(hi, c);
    if (vec_interp) {
      for (int ch = lo + 4 * lane; ch < ih; ch += 128) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p0 + ch));
        const float4 b = __ldg(reinterpret_cast<const float4*>(p1 + ch));
        const float4 e = __ldg(reinterpret_cast<const float4*>(p2 + ch));
        __stcs(reinterpret_cast<float4*>(o + ch),
               make_float4(interp1(a.x, b.x, e.x, w0, w1, w2),
                           interp1(a.y, b.y, e.y, w0, w1, w2),
                           interp1(a.z, b.z, e.z, w0, w1, w2),
                           interp1(a.w, b.w, e.w, w0, w1, w2)));
      }
    } else {
      for (int ch = lo + lane; ch < ih; ch += 32)
        __stcs(o + ch, interp1(__ldg(p0 + ch), __ldg(p1 + ch), __ldg(p2 + ch),
                               w0, w1, w2));
    }
    if (c1 > 0) {
      const float* q = skip + row * c1;
      const int sl = max(lo, c);
      if (vec_skip) {
        for (int ch = sl + 4 * lane; ch < hi; ch += 128)
          __stcs(reinterpret_cast<float4*>(o + ch),
                 __ldcs(reinterpret_cast<const float4*>(q + (ch - c))));
      } else {
        for (int ch = sl + lane; ch < hi; ch += 32) __stcs(o + ch, __ldcs(q + (ch - c)));
      }
    }
  }
}

constexpr int kStageThreads = 512;
constexpr int kMaxChunk = 2048;  // rows a staged CTA: 4 a thread for the weights

constexpr int kStage = 32;  // channels a staged slice

// Staged form (no skip; C a multiple of kStage): CTA (scene, slice of
// kStage channels, chunk of up to kMaxChunk target rows) copies the scene's
// sources' slice into shared memory by cp.async and, while it is in flight,
// computes its rows' weights from the distances (a thread a row, every
// load issued first) and keeps them beside the rows' indices; then 8 lanes
// a row, a float4 each, gather from shared memory and stream the row's
// slice out. The sources are read from L2 once a CTA instead of three
// times a target.
__global__ void __launch_bounds__(kStageThreads) interp_mm_kernel_staged(
    const float* __restrict__ points, const int* __restrict__ idx,
    const float* __restrict__ wd, bool from_dist, int n, int m, int c,
    int chunk, float* __restrict__ out) {
  constexpr int kVec = kStage / 4;  // float4s a row's slice, lanes a row
  constexpr int kRows = 32 / kVec;  // rows a warp step
  constexpr int kPerThread = kMaxChunk / kStageThreads;
  extern __shared__ float4 smem4[];
  float4* src_s = smem4;  // [m][kVec]
  int4* idx_s = reinterpret_cast<int4*>(smem4 + static_cast<size_t>(m) * kVec);
  float4* w_s = smem4 + static_cast<size_t>(m) * kVec + chunk;  // [chunk]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunks = (n + chunk - 1) / chunk;
  const int slices = c / kStage;
  const int q = blockIdx.x % chunks;
  const int sl = (blockIdx.x / chunks) % slices;
  const int b = blockIdx.x / (chunks * slices);
  const int r_lo = q * chunk, r_hi = min(n, r_lo + chunk);

  const float* pb = points + static_cast<size_t>(b) * m * c + sl * kStage;
  for (int e = tid; e < m * kVec; e += kStageThreads) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(src_s + e));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(pb + static_cast<size_t>(e / kVec) * c + (e % kVec) * 4)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  int iv[kPerThread][3];
  float dv[kPerThread][3];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int r = r_lo + tid + k * kStageThreads;
    const size_t row = static_cast<size_t>(b) * n + min(r, n - 1);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      iv[k][t] = __ldcs(idx + row * 3 + t);
      dv[k][t] = __ldcs(wd + row * 3 + t);
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int r = r_lo + tid + k * kStageThreads;
    float w0 = dv[k][0], w1 = dv[k][1], w2 = dv[k][2];
    if (from_dist) {
      const float r0 = __fdiv_rn(1.f, w0 < kEps ? kEps : w0);
      const float r1 = __fdiv_rn(1.f, w1 < kEps ? kEps : w1);
      const float r2 = __fdiv_rn(1.f, w2 < kEps ? kEps : w2);
      const float sum = __fadd_rn(__fadd_rn(r0, r1), r2);
      w0 = __fdiv_rn(r0, sum);
      w1 = __fdiv_rn(r1, sum);
      w2 = __fdiv_rn(r2, sum);
    }
    if (r < r_hi) {
      idx_s[r - r_lo] = make_int4(iv[k][0], iv[k][1], iv[k][2], 0);
      w_s[r - r_lo] = make_float4(w0, w1, w2, 0.f);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int g = lane / kVec, v = lane % kVec;
  float* ob = out + static_cast<size_t>(b) * n * c + sl * kStage + 4 * v;
#pragma unroll 2
  for (int r = r_lo + warp * kRows + g; r < r_hi; r += kStageThreads / 32 * kRows) {
    const int4 ii = idx_s[r - r_lo];
    const float4 ww = w_s[r - r_lo];
    const float4 a = src_s[ii.x * kVec + v];
    const float4 e = src_s[ii.y * kVec + v];
    const float4 f = src_s[ii.z * kVec + v];
    __stcs(reinterpret_cast<float4*>(ob + static_cast<size_t>(r) * c),
           make_float4(interp1(a.x, e.x, f.x, ww.x, ww.y, ww.z),
                       interp1(a.y, e.y, f.y, ww.x, ww.y, ww.z),
                       interp1(a.z, e.z, f.z, ww.x, ww.y, ww.z),
                       interp1(a.w, e.w, f.w, ww.x, ww.y, ww.z)));
  }
}

// A refused call's error is also the runtime's last error: clear it, so that
// the next launch's check does not report it again.
cudaError_t refused(cudaError_t err) {
  cudaGetLastError();
  return err;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

cudaError_t launch_staged(const float* points, const int* idx, const float* wd,
                          bool from_dist, int nb, int n, int m, int c, int chunk,
                          float* out, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(m) * kStage / 4 + 2 * static_cast<size_t>(chunk)) * 16;
  const long blocks = static_cast<long>(nb) * (c / kStage) * ((n + chunk - 1) / chunk);
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(interp_mm_kernel_staged,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return refused(err);
  interp_mm_kernel_staged<<<static_cast<unsigned>(blocks), kStageThreads, smem, stream>>>(
      points, idx, wd, from_dist, n, m, c, chunk, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gspn

// wd: (nb, n, 3) weights, or three_nn's squared distances when from_dist;
// skip: (nb, n, c1) rows copied after the c interpolated channels (c1 = 0:
// none); out: (nb, n, c + c1). The plan (interpolate.py interp_mm_plan):
// stage 0, per_task rows a warp's task (1-8) and the output row in
// `slices` slices; or stage 32, the staged form over slices of 32 channels
// and chunks of per_task rows (no skip, c a multiple of 32, 16-byte aligned
// rows, the slice and chunk within shared memory).
extern "C" int gspn_interp_mm(const float* points, const int* idx,
                              const float* wd, int from_dist, const float* skip,
                              int nb, int n, int m, int c, int c1, int per_task,
                              int slices, int stage, float* out, cudaStream_t stream) {
  if (nb < 0 || n < 0 || m < 0 || c < 0 || c1 < 0 || per_task < 1 || slices < 1 ||
      (c1 > 0 && skip == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long rows = static_cast<long>(nb) * n;
  const int ctot = c + c1;
  if (stage != 0) {
    if (stage != kStage || c1 != 0 || c % kStage != 0 || per_task > kMaxChunk ||
        !aligned16(points) || !aligned16(out))
      return static_cast<int>(cudaErrorInvalidValue);
    if (rows == 0 || c == 0) return static_cast<int>(cudaGetLastError());
    return static_cast<int>(launch_staged(points, idx, wd, from_dist != 0, nb, n, m, c,
                                          per_task, out, stream));
  }
  if (per_task > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || ctot == 0) return static_cast<int>(cudaGetLastError());
  const int slice_w =
      ((ctot + slices - 1) / slices + kSliceUnit - 1) / kSliceUnit * kSliceUnit;
  const long tasks = (rows + per_task - 1) / per_task * ((ctot + slice_w - 1) / slice_w);
  const long blocks = (tasks + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte accesses where every row of a part starts on a 16-byte boundary
  const bool rows4 = aligned16(out) && ctot % 4 == 0 && c % 4 == 0;
  const bool vec_interp = rows4 && aligned16(points);
  const bool vec_skip = rows4 && c1 % 4 == 0 && aligned16(skip);
  interp_mm_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
      points, idx, wd, from_dist != 0, skip, rows, n, m, c, c1, per_task,
      (ctot + slice_w - 1) / slice_w, slice_w, vec_interp, vec_skip, out);
  return static_cast<int>(cudaGetLastError());
}
