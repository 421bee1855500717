// Inverse-distance interpolation of three source rows per target:
// out[b, n, :] = sum_k w[b, n, k] * points[b, idx[b, n, k], :].
//
// Replaces gspn_tpu/ops/interpolate.py::_interp_mm_kernel, the Pallas kernel
// that writes each target row's three weights into a sparse (targets x
// sources) tile and multiplies it with the source block on the MXU: a way
// to gather on a TPU. Here the gather is a gather, with no bound on the
// source block.
//
// What bounds it on the card: bytes. Each target reads three source rows
// (at most 1024 x 512 floats of sources per scene on the slice, resident in
// L2) and writes one row; at FP4 the write alone is 8 x 8192 x 128 x 4 B.
// Design: one warp per target row; lanes walk the channels, so the three
// row reads and the write are coalesced.
//
// Numerics: the terms are summed in neighbor order, (p_0*w_0 + p_1*w_1) +
// p_2*w_2, with round-to-nearest intrinsics, never contracted into FMAs:
// bitwise interpolate.py three_interpolate (and the JAX package's exact
// interpolation), within 1-2 ulp of the TPU's source-ordered matmul sum.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // target rows per block

__global__ void interp_mm_kernel(const float* __restrict__ points,
                                 const int* __restrict__ idx,
                                 const float* __restrict__ weight, long rows,
                                 int n, int m, int c, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long b = row / n;
  const float w0 = weight[row * 3], w1 = weight[row * 3 + 1],
              w2 = weight[row * 3 + 2];
  const float* base = points + b * m * c;
  const float* p0 = base + static_cast<long>(idx[row * 3]) * c;
  const float* p1 = base + static_cast<long>(idx[row * 3 + 1]) * c;
  const float* p2 = base + static_cast<long>(idx[row * 3 + 2]) * c;
  float* o = out + row * c;
  for (int ch = lane; ch < c; ch += 32) {
    o[ch] = __fadd_rn(__fadd_rn(__fmul_rn(p0[ch], w0), __fmul_rn(p1[ch], w1)),
                      __fmul_rn(p2[ch], w2));
  }
}

}  // namespace

extern "C" int gspn_interp_mm(const float* points, const int* idx,
                              const float* weight, int nb, int n, int m, int c,
                              float* out, cudaStream_t stream) {
  const long rows = static_cast<long>(nb) * n;
  const long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0 && c > 0)
    interp_mm_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
        points, idx, weight, rows, n, m, c, out);
  return static_cast<int>(cudaGetLastError());
}
