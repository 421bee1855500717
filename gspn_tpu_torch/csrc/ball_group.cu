// Fused multi-radius ball query + group + centre subtract.
//
// gspn_ball_group replaces gspn_tpu/ops/ball_group.py::_fused_kernel
// (select="first"), the Pallas kernel that scans point chunks with early
// exit and extracts the first K hits per query with per-window min/select
// chains. gspn_ball_group_strided replaces
// gspn_tpu/ops/ball_group.py::_fused_kernel_strided (select="strided"), its
// two-phase form: a count pass, then the hits of rank floor(j*total/K).
//
// On Hopper the serial first-come scan maps onto one warp per query with a
// ballot per 32 points (group_scan.cuh): all concentric scales share one
// squared distance per point. First-K exits once every scale is full, so
// what bounds it is the share of the scene each query must read before its
// balls fill; strided reads the whole scene twice (count, then rank), which
// the L2-resident scene keeps off device memory.

#include "group_scan.cuh"

extern "C" int gspn_ball_group(const float* xyz1, const uint8_t* valid1,
                               const float* xyz2, int nb, int n, int m,
                               int nscales, const float* r2s, const int* ks,
                               int* const* idx, int* const* cnt,
                               float* const* local, cudaStream_t stream) {
  gspn::GroupOut out;
  const int err = gspn::ball_group_out(nscales, r2s, ks, idx, cnt, local, &out);
  if (err) return err;
  return gspn::launch_group_scan<false, false, true>(xyz1, valid1, xyz2, nb,
                                                     n, m, out, stream);
}

extern "C" int gspn_ball_group_strided(const float* xyz1,
                                       const uint8_t* valid1,
                                       const float* xyz2, int nb, int n,
                                       int m, int nscales, const float* r2s,
                                       const int* ks, int* const* idx,
                                       int* const* cnt, float* const* local,
                                       cudaStream_t stream) {
  gspn::GroupOut out;
  const int err = gspn::ball_group_out(nscales, r2s, ks, idx, cnt, local, &out);
  if (err) return err;
  return gspn::launch_group_scan<false, true, true>(xyz1, valid1, xyz2, nb,
                                                    n, m, out, stream);
}
