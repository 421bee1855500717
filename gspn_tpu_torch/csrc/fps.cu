// Greedy farthest point sampling, one thread block per row.
//
// Replaces gspn_tpu/ops/fps.py::_fps_kernel (the Pallas TPU kernel that
// keeps the per-point min-distance buffer in VMEM and packs rows on
// sublanes).
//
// What bounds it on the card: the npoint-long dependent chain
// (distance update -> block-wide argmax -> next centre), not bytes or
// FLOPs: a row of N points is 16*N bytes and each step is ~9*N flops.
// Design: the row's coordinates and its running min-distance buffer live in
// dynamic shared memory for the whole chain (16 B per point: 128 KB at the
// whole-scene chain of 8192 points), so each step reads no device memory.
// Each step is one update pass (each thread strides over the row), then a
// (value, index) argmax with lowest-index ties: warp shuffles, one word per
// warp through shared memory, and a last warp-level reduce. Rows (scene x
// chain) are independent blocks, so the segmented pipeline's 8 chains per
// scene fill 8*B SMs at once. A row longer than shared memory holds is
// refused by the Python wrapper.
//
// Contract (fps.py:_fps_single_xla): invalid points start at -1 and are
// never picked while a valid one remains; the first pick is the first
// valid point (0 if none); ties go to the lowest index.

#include "common.cuh"

namespace {

__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void fps_kernel(const float* __restrict__ xyz,
                           const uint8_t* __restrict__ valid, int n,
                           int npoint, int* __restrict__ out) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* mind = sz + n;
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int s_first;
  __shared__ int s_next;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* p = xyz + static_cast<size_t>(row) * n * 3;
  const uint8_t* v = valid ? valid + static_cast<size_t>(row) * n : nullptr;
  int* o = out + static_cast<size_t>(row) * npoint;

  if (tid == 0) s_first = n;
  __syncthreads();
  int my_first = n;
  for (int j = tid; j < n; j += blockDim.x) {
    sx[j] = p[3 * j];
    sy[j] = p[3 * j + 1];
    sz[j] = p[3 * j + 2];
    const bool ok = v == nullptr || v[j] != 0;
    mind[j] = ok ? 1e10f : -1.0f;
    if (ok && j < my_first) my_first = j;
  }
  if (my_first < n) atomicMin(&s_first, my_first);
  __syncthreads();
  int prev = s_first < n ? s_first : 0;
  if (tid == 0) o[0] = prev;

  for (int k = 1; k < npoint; ++k) {
    const float cx = sx[prev], cy = sy[prev], cz = sz[prev];
    float bv = -CUDART_INF_F;
    int bi = n;
    for (int j = tid; j < n; j += blockDim.x) {
      const float d = gspn::sqdist(sx[j], sy[j], sz[j], cx, cy, cz);
      const float m = fminf(mind[j], d);
      mind[j] = m;
      if (m > bv) {  // j ascends within a thread: strict > keeps the lowest
        bv = m;
        bi = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(gspn::kFullMask, bv, off);
      const int oi = __shfl_down_sync(gspn::kFullMask, bi, off);
      argmax_merge(bv, bi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -CUDART_INF_F;
      bi = lane < nwarps ? red_i[lane] : n;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(gspn::kFullMask, bv, off);
        const int oi = __shfl_down_sync(gspn::kFullMask, bi, off);
        argmax_merge(bv, bi, ov, oi);
      }
      if (lane == 0) {
        s_next = bi;
        o[k] = bi;
      }
    }
    __syncthreads();
    prev = s_next;  // next written after the first barrier of step k+1
  }
}

}  // namespace

extern "C" const char* gspn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int gspn_fps(const float* xyz, const uint8_t* valid, int rows, int n,
                        int npoint, int* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n) * 4 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = ((n + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  fps_kernel<<<rows, threads, smem, stream>>>(xyz, valid, n, npoint, out);
  return static_cast<int>(cudaGetLastError());
}
