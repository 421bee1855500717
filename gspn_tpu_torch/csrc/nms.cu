// Greedy 3D NMS over a score-sorted IoU matrix.
//
// Replaces gspn_tpu/ops/nms.py::_nms_kernel, the Pallas kernel that runs
// the sequential greedy loop for one scene inside VMEM (grid (B,)): for i
// in order, keep[i] = alive[i]; a kept i clears alive[j] for every later j
// with iou[i][j] > thresh.
//
// On Hopper: one block per scene, the alive flags in dynamic shared memory
// (R bytes), each thread owning candidates j = tid, tid + blockDim, ... so
// that a row of the IoU matrix is read coalesced. Each of the R steps reads
// alive[i], lets every thread clear its own flags from row i (only the
// owner ever writes a flag), and ends with __syncthreads(): the keep mask
// is exactly the sequential loop's. What bounds it is the R dependent
// steps, each a barrier and an L2 read: latency, not bytes or operations
// (R*R compares per scene). The flags fit shared memory up to ~227k boxes;
// the (B, R, R) IoU matrix the wrapper builds comes first (the Python
// wrapper's MAX_R). The threshold arrives as the f32 that the JAX package's
// weak-typed Python float becomes, and the compare is in f32.

#include "common.cuh"

namespace {

__global__ void nms_kernel(const float* __restrict__ iou,
                           const uint8_t* __restrict__ alive_in, int r,
                           float thresh, uint8_t* __restrict__ keep) {
  extern __shared__ uint8_t alive[];
  const int b = blockIdx.x;
  const float* m = iou + static_cast<size_t>(b) * r * r;
  for (int j = threadIdx.x; j < r; j += blockDim.x)
    alive[j] = alive_in[static_cast<size_t>(b) * r + j];
  __syncthreads();
  for (int i = 0; i < r; ++i) {
    const uint8_t a = alive[i];
    if (threadIdx.x == 0) keep[static_cast<size_t>(b) * r + i] = a;
    if (a) {
      const float* row = m + static_cast<size_t>(i) * r;
      for (int j = threadIdx.x; j < r; j += blockDim.x)
        if (j > i && row[j] > thresh) alive[j] = 0;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int gspn_nms(const float* iou, const uint8_t* alive, int nb, int r,
                        float thresh, uint8_t* keep, cudaStream_t stream) {
  if (r < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, r);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = (r + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  if (nb > 0) nms_kernel<<<nb, threads, r, stream>>>(iou, alive, r, thresh, keep);
  return static_cast<int>(cudaGetLastError());
}
