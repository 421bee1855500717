// Greedy 3D NMS over a score-sorted IoU matrix.
//
// Replaces gspn_tpu/ops/nms.py::_nms_kernel, the Pallas kernel that runs
// the sequential greedy loop for one scene inside VMEM (grid (B,)): for i
// in order, keep[i] = alive[i]; a kept i clears alive[j] for every later j
// with iou[i][j] > thresh.
//
// On Hopper: one block per scene, one thread per candidate j (R <= 1024),
// the alive flags in shared memory. Each of the R steps reads alive[i],
// lets the threads clear their own flag from row i of the IoU matrix (a
// coalesced read from L2; the whole (R, R) matrix is 16 KB at R = 64), and
// ends with __syncthreads(). What bounds it is the R dependent steps, each
// a barrier and an L2 read: latency, not bytes or operations (R*R compares
// per scene). The threshold arrives as the f32 that the JAX package's
// weak-typed Python float becomes, and the compare is in f32.

#include "common.cuh"

namespace {

constexpr int kMaxR = 1024;

__global__ void nms_kernel(const float* __restrict__ iou,
                           const uint8_t* __restrict__ alive_in, int r,
                           float thresh, uint8_t* __restrict__ keep) {
  __shared__ uint8_t alive[kMaxR];
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const float* m = iou + static_cast<size_t>(b) * r * r;
  if (j < r) alive[j] = alive_in[static_cast<size_t>(b) * r + j];
  __syncthreads();
  for (int i = 0; i < r; ++i) {
    const uint8_t a = alive[i];
    if (j == 0) keep[static_cast<size_t>(b) * r + i] = a;
    if (a && j > i && j < r && m[static_cast<size_t>(i) * r + j] > thresh)
      alive[j] = 0;
    __syncthreads();
  }
}

}  // namespace

extern "C" int gspn_nms(const float* iou, const uint8_t* alive, int nb, int r,
                        float thresh, uint8_t* keep, cudaStream_t stream) {
  if (r < 1 || r > kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (r + 31) / 32 * 32;
  if (nb > 0) nms_kernel<<<nb, threads, 0, stream>>>(iou, alive, r, thresh, keep);
  return static_cast<int>(cudaGetLastError());
}
