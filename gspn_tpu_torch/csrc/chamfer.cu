// Nearest valid source per target: the argmin behind the chamfer loss.
//
// Replaces gspn_tpu/ops/chamfer.py::_nn_kernel (called through
// _argmin_pallas), the Pallas kernel that lays a tile of targets along
// sublanes and the whole padded source row along lanes, builds the
// (targets x sources) squared-distance tile in VMEM and reduces it with one
// argmin.
//
// Contract (ops/common.py masked_sqdist + argmin): d2 = dx*dx + dy*dy +
// dz*dz in that order with round-to-nearest intrinsics, an invalid source
// counts as 1e10, and the index is the lowest one among equal minima, so a
// target whose sources are all padded gets index 0 (argmin over a row of
// 1e10s). Bitwise equal to the plain PyTorch version.
//
// What bounds it on the card: the N*M distance evaluations (9 float32
// operations and a compare each, no FMA); inputs and outputs are a few
// bytes per point. At the training step's shapes (256 rows x 256 targets x
// 256 sources, twice a step) the operations bound is ~0.0045 ms per launch
// (0.009 ms a step) at 33.5 T float32 operations/s, the H100's lanes
// without FMA. Design: one thread per target scans the sources
// in index order and keeps (best, index), replacing them only on a strict
// <; the block stages the row's sources through shared memory in tiles of
// kTile, so each source is read from device memory once per block and
// broadcast to the block's kThreads targets. At 256 rows x 256 targets the
// grid is 512 blocks of 128 threads: every SM gets work, and the launch is
// latency-bound (each thread's 256-step dependent scan), not starved.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 2048;  // 26 KB of shared memory per block

__global__ void nn_argmin_kernel(const float* __restrict__ xyz1,
                                 const float* __restrict__ xyz2,
                                 const uint8_t* __restrict__ valid2, int n,
                                 int m, int* __restrict__ idx) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];
  __shared__ uint8_t sv[kTile];
  const int b = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const bool active = t < n;
  const float* tgt = xyz1 + (static_cast<size_t>(b) * n + (active ? t : 0)) * 3;
  const float tx = tgt[0], ty = tgt[1], tz = tgt[2];
  const float* src = xyz2 + static_cast<size_t>(b) * m * 3;
  const uint8_t* v = valid2 ? valid2 + static_cast<size_t>(b) * m : nullptr;

  float best = CUDART_INF_F;
  int best_j = 0;
  for (int base = 0; base < m; base += kTile) {
    const int len = m - base < kTile ? m - base : kTile;
    __syncthreads();  // the previous tile has been read by every thread
    for (int u = threadIdx.x; u < len; u += kThreads) {
      const int j = base + u;
      sx[u] = src[3 * j];
      sy[u] = src[3 * j + 1];
      sz[u] = src[3 * j + 2];
      sv[u] = v == nullptr ? 1 : v[j];
    }
    __syncthreads();
    if (!active) continue;
    for (int u = 0; u < len; ++u) {
      const float d = sv[u] ? gspn::sqdist(tx, ty, tz, sx[u], sy[u], sz[u]) : 1e10f;
      if (d < best) {
        best = d;
        best_j = base + u;
      }
    }
  }
  if (active) idx[static_cast<size_t>(b) * n + t] = best_j;
}

}  // namespace

extern "C" int gspn_nn_argmin(const float* xyz1, const float* xyz2,
                              const uint8_t* valid2, int nb, int n, int m,
                              int* idx, cudaStream_t stream) {
  if (nb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads, nb);
  if (grid.x > 0 && nb > 0 && m > 0)
    nn_argmin_kernel<<<grid, kThreads, 0, stream>>>(xyz1, xyz2, valid2, n, m,
                                                    idx);
  return static_cast<int>(cudaGetLastError());
}
