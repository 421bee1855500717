// Deterministic index-add: the backward of a row gather.
//
// Not a port of a TPU kernel: the JAX package gathers outside Pallas and
// XLA adds the gradient rows back in a fixed order. torch.gather's backward
// on the card adds them with atomics in no fixed order, so a training step
// was not bitwise reproducible. This kernel is its repair.
//
// out[b, n, c] = sum of src[b, p, c] over the positions p with idx[b, p] ==
// n, in ascending p, starting from +0.0, each add rounded to nearest
// (__fadd_rn): bitwise the plain PyTorch version and the CPU's
// scatter_add, which add in the same order.
//
// The wrapper sorts each row's indices with torch.sort(stable=True) for
// the permutation only (a stable sort keeps ascending positions within a
// run of equal indices). Here one thread per (b, n, c) finds its run
// [lower_bound(n), lower_bound(n + 1)) in the sorted indices by binary
// search and walks it, reading src rows through the permutation: adjacent
// threads take adjacent channels of one row, so the reads of a wide row are
// coalesced. What bounds it on the card: bytes (each src element read
// once, each output written once); the run walk is a dependent chain only
// where many positions share an index.

#include "common.cuh"

namespace {

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int len, int key) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void index_add_kernel(const float* __restrict__ src,
                                 const int* __restrict__ sorted,
                                 const int64_t* __restrict__ perm, int m,
                                 int n, int c, float* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t per_row = static_cast<int64_t>(n) * c;
  const int b = blockIdx.y;
  if (t >= per_row) return;
  const int row = static_cast<int>(t / c);
  const int ch = static_cast<int>(t % c);
  const int* s = sorted + static_cast<size_t>(b) * m;
  const int64_t* pm = perm + static_cast<size_t>(b) * m;
  const float* x = src + static_cast<size_t>(b) * m * c;
  const int start = lower_bound(s, m, row);
  const int end = lower_bound(s, m, row + 1);
  float acc = 0.0f;
  for (int q = start; q < end; ++q)
    acc = __fadd_rn(acc, x[static_cast<size_t>(pm[q]) * c + ch]);
  out[static_cast<size_t>(b) * per_row + t] = acc;
}

}  // namespace

extern "C" int gspn_index_add(const float* src, const int* sorted, const int64_t* perm,
                              int nb, int m, int n, int c, float* out,
                              cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t per_row = static_cast<int64_t>(n) * c;
  const int64_t blocks = (per_row + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff || nb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (nb > 0 && blocks > 0)
    index_add_kernel<<<dim3(static_cast<unsigned>(blocks), nb), kThreads, 0, stream>>>(
        src, sorted, perm, m, n, c, out);
  return static_cast<int>(cudaGetLastError());
}
