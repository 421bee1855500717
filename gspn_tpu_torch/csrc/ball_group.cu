// Fused multi-radius ball query + group + centre subtract.
//
// Replaces gspn_tpu/ops/ball_group.py::_fused_kernel (select="first"), the
// Pallas kernel that scans point chunks with early exit and extracts the
// first K hits per query with per-window min/select chains.
//
// On Hopper the serial first-come scan maps onto one warp per query with a
// ballot per 32 points (group_scan.cuh): all concentric scales share one
// squared distance per point, and the scan exits once every scale is full.
// What bounds it is the share of the scene each query must read before its
// balls fill (see group_scan.cuh); the L2-resident scene keeps that
// off device memory.

#include "group_scan.cuh"

extern "C" int gspn_ball_group(const float* xyz1, const uint8_t* valid1,
                               const float* xyz2, int nb, int n, int m,
                               int nscales, const float* r2s, const int* ks,
                               int* const* idx, int* const* cnt,
                               float* const* local, cudaStream_t stream) {
  if (nscales < 1 || nscales > gspn::kMaxScales)
    return static_cast<int>(cudaErrorInvalidValue);
  gspn::GroupOut out{};
  out.nscales = nscales;
  for (int s = 0; s < nscales; ++s) {
    out.k[s] = ks[s];
    out.r2[s] = r2s[s];
    out.idx[s] = idx[s];
    out.cnt[s] = cnt[s];
    out.local[s] = local[s];
  }
  return gspn::launch_group_scan<false>(xyz1, valid1, xyz2, nb, n, m, out,
                                        stream);
}
