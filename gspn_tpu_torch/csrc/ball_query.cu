// Index-only multi-radius ball query: (idx, cnt) per scale, no coordinates.
//
// gspn_ball_query and gspn_ball_query_strided replace
// gspn_tpu/ops/ball_query.py::_ball_query_multi_kernel, the Pallas kernel
// that computes one (TM, Npad) distance tile shared by every scale and
// extracts each scale's first K hits (select="first") or, after a lane
// prefix sum, the hits of rank floor(j*total/K) (select="strided"); here
// each selection has its own entry point, as the ball group's have.
//
// On Hopper it is the warp-per-query scan of group_scan.cuh, indices only:
// first-K exits once every scale is full, strided counts over the whole
// scene and then ranks up to its last target.
// What bounds it is reading the L2-resident scene (a prefix, or all of it
// and then up to the last target); its writes are 4*K bytes per query and
// scale.

#include "group_scan.cuh"

extern "C" int gspn_ball_query(const float* xyz1, const uint8_t* valid1,
                               const float* xyz2, int nb, int n, int m,
                               int nscales, const float* r2s, const int* ks,
                               int* const* idx, int* const* cnt,
                               cudaStream_t stream) {
  gspn::GroupOut out;
  const int err =
      gspn::ball_group_out(nscales, r2s, ks, idx, cnt, nullptr, &out);
  if (err) return err;
  return gspn::launch_group_scan<false>(xyz1, valid1, xyz2, nb, n, m, out,
                                         stream);
}

extern "C" int gspn_ball_query_strided(const float* xyz1,
                                       const uint8_t* valid1,
                                       const float* xyz2, int nb, int n,
                                       int m, int nscales, const float* r2s,
                                       const int* ks, int* const* idx,
                                       int* const* cnt, cudaStream_t stream) {
  gspn::GroupOut out;
  const int err =
      gspn::ball_group_out(nscales, r2s, ks, idx, cnt, nullptr, &out);
  if (err) return err;
  return gspn::launch_group_scan<true>(xyz1, valid1, xyz2, nb, n, m, out,
                                        stream);
}
