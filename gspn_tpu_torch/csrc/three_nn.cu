// Three nearest valid sources per target point.
//
// Replaces gspn_tpu/ops/interpolate.py::_three_nn_kernel, the Pallas kernel
// that builds a (targets x sources) distance tile in VMEM and extracts the
// top 3 with three masked min passes.
//
// What bounds it on the card: the N*M distance evaluations (9 flops each,
// no FMA), since the sources are few (<= 1024 on the slice) and the outputs
// are 24 bytes per target. Design: one thread per target keeps a sorted
// top-3 in registers; the block stages 256 sources at a time through shared
// memory, so each source is read from device memory once per block and
// broadcast to its 256 targets from shared memory.
//
// Contract (interpolate.py three_nn, XLA branch): squared distances
// ascending, ties to the lower source index (a candidate displaces an
// entry only on strict <, and sources arrive in index order). An invalid
// source has distance 1e10 and still ranks, so a target with fewer than 3
// valid sources gets invalid ones at 1e10, lowest index first. The Python
// wrapper refuses M < 3.

#include "common.cuh"

namespace {

constexpr int kTile = 256;

__global__ void three_nn_kernel(const float* __restrict__ xyz1,
                                const float* __restrict__ xyz2,
                                const uint8_t* __restrict__ valid2, int n,
                                int m, float* __restrict__ dist,
                                int* __restrict__ idx) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];
  __shared__ uint8_t sv[kTile];
  const int b = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = t < n;
  const float* tgt = xyz1 + (static_cast<size_t>(b) * n + (active ? t : 0)) * 3;
  const float tx = tgt[0], ty = tgt[1], tz = tgt[2];
  const float* src = xyz2 + static_cast<size_t>(b) * m * 3;
  const uint8_t* v = valid2 ? valid2 + static_cast<size_t>(b) * m : nullptr;

  float d0 = CUDART_INF_F, d1 = CUDART_INF_F, d2 = CUDART_INF_F;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int base = 0; base < m; base += kTile) {
    __syncthreads();
    const int j = base + threadIdx.x;
    if (j < m) {
      sx[threadIdx.x] = src[3 * j];
      sy[threadIdx.x] = src[3 * j + 1];
      sz[threadIdx.x] = src[3 * j + 2];
      sv[threadIdx.x] = v == nullptr ? 1 : v[j];
    }
    __syncthreads();
    if (!active) continue;
    const int len = m - base < kTile ? m - base : kTile;
    for (int u = 0; u < len; ++u) {
      float d = gspn::sqdist(tx, ty, tz, sx[u], sy[u], sz[u]);
      if (!sv[u]) d = 1e10f;
      if (d < d2) {
        const int jj = base + u;
        if (d < d1) {
          d2 = d1;
          i2 = i1;
          if (d < d0) {
            d1 = d0;
            i1 = i0;
            d0 = d;
            i0 = jj;
          } else {
            d1 = d;
            i1 = jj;
          }
        } else {
          d2 = d;
          i2 = jj;
        }
      }
    }
  }
  if (active) {
    const size_t o = (static_cast<size_t>(b) * n + t) * 3;
    dist[o] = d0;
    dist[o + 1] = d1;
    dist[o + 2] = d2;
    idx[o] = i0;
    idx[o + 1] = i1;
    idx[o + 2] = i2;
  }
}

}  // namespace

extern "C" int gspn_three_nn(const float* xyz1, const float* xyz2,
                             const uint8_t* valid2, int nb, int n, int m,
                             float* dist, int* idx, cudaStream_t stream) {
  if (nb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kTile - 1) / kTile, nb);
  if (grid.x > 0 && nb > 0)
    three_nn_kernel<<<grid, kTile, 0, stream>>>(xyz1, xyz2, valid2, n, m,
                                                dist, idx);
  return static_cast<int>(cudaGetLastError());
}
