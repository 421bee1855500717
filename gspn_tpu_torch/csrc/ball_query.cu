// Index-only multi-radius ball query: (idx, cnt) per scale, no coordinates.
//
// gspn_ball_query and gspn_ball_query_strided replace
// gspn_tpu/ops/ball_query.py::_ball_query_multi_kernel, the Pallas kernel
// that computes one (TM, Npad) distance tile shared by every scale and
// extracts each scale's first K hits (select="first") or, after a lane
// prefix sum, the hits of rank floor(j*total/K) (select="strided"); here
// each selection has its own entry point, as the ball group's have.
//
// The ball query computes the ball group's indices and counts, so it runs
// the ball group's kernels with kCoords false: first-K on
// group_first_kernel<Ball<n>, false> (group_first.cuh: the scene staged
// through shared memory in cp.async tiles for a CTA of queries, a query
// split over 1-16 warps, an early exit once every query is full) and
// strided on group_strided_kernel<Ball<n>, false> (group_strided.cuh: each
// point tested once into ballots, the sampled ranks read from them, a warp
// a query reading short scenes from device memory). Each slot writes its
// index only; the plan (split, direct, ballots) is the ball group's. What
// bounds it, as the ball group: the point tests; its writes are 4*K bytes a
// query and scale.

#include "group_strided.cuh"

// split: warps a query, 0 for group_first_split's choice (another value
// only to time one split against another).
extern "C" int gspn_ball_query(const float* xyz1, const uint8_t* valid1,
                               const float* xyz2, int nb, int n, int m,
                               int nscales, const float* r2s, const int* ks,
                               int* const* idx, int* const* cnt, int split,
                               cudaStream_t stream) {
  gspn::GroupOut out;
  const int err =
      gspn::ball_group_out(nscales, r2s, ks, idx, cnt, nullptr, &out);
  if (err) return err;
  return gspn::with_scales(nscales, [&](auto s) {
    return gspn::launch_group_first<gspn::Ball<decltype(s)::value>, false>(
        xyz1, valid1, xyz2, nb, n, m, split, out, stream);
  });
}

// split, direct and ballots: as gspn_ball_group_strided's
// (ops/ball_query.py strided_plan).
extern "C" int gspn_ball_query_strided(const float* xyz1,
                                       const uint8_t* valid1,
                                       const float* xyz2, int nb, int n,
                                       int m, int nscales, const float* r2s,
                                       const int* ks, int* const* idx,
                                       int* const* cnt, int split,
                                       int direct, unsigned* ballots,
                                       cudaStream_t stream) {
  gspn::GroupOut out;
  const int err =
      gspn::ball_group_out(nscales, r2s, ks, idx, cnt, nullptr, &out);
  if (err) return err;
  return gspn::with_scales(nscales, [&](auto s) {
    return gspn::launch_group_strided<gspn::Ball<decltype(s)::value>, false>(
        xyz1, valid1, xyz2, nb, n, m, split, direct, ballots, out, stream);
  });
}
