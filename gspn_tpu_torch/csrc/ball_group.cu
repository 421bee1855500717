// Fused multi-radius ball query + group + centre subtract.
//
// gspn_ball_group replaces gspn_tpu/ops/ball_group.py::_fused_kernel
// (select="first"), the Pallas kernel that scans point chunks with early
// exit and extracts the first K hits per query with per-window min/select
// chains. gspn_ball_group_strided replaces
// gspn_tpu/ops/ball_group.py::_fused_kernel_strided (select="strided"), its
// two-phase form: a count pass, then the hits of rank floor(j*total/K).
//
// First-K runs group_first_kernel<Ball<nscales>, true> (group_first.cuh,
// shared with the first-S box group and, without coordinates, the ball
// query): the scene staged through shared memory in cp.async tiles for a
// CTA of queries of one scene, float4 points with NaN x where invalid, a
// query split over 1-16 warps when queries are few, and an early exit once
// every query is full. Strided runs group_strided_kernel<Ball<nscales>,
// true> (group_strided.cuh, shared with the strided box group and the
// strided ball query): the same staging and split, each point tested once
// with its ballots kept, then the ranks read from the ballots. What bounds
// both: the point tests; most SA1 balls (r 0.1) do not fill K before the
// scene ends, and a strided query tests all of it. The contract is the
// reference's: d2 < r2 strictly (r2 rounded once in Python),
// gspn::sqdist in the plain order, local = p - centre with __fsub_rn,
// replicate-first padding, an empty row takes index 0 and point 0 minus
// the centre, up to kMaxScales concentric scales sharing one distance, cnt
// capped at K.

#include "group_strided.cuh"

// split: warps a query, 0 for group_first_split's choice (another value
// only to time one split against another).
extern "C" int gspn_ball_group(const float* xyz1, const uint8_t* valid1,
                               const float* xyz2, int nb, int n, int m,
                               int nscales, const float* r2s, const int* ks,
                               int* const* idx, int* const* cnt,
                               float* const* local, int split,
                               cudaStream_t stream) {
  gspn::GroupOut out;
  const int err = gspn::ball_group_out(nscales, r2s, ks, idx, cnt, local, &out);
  if (err) return err;
  return gspn::with_scales(nscales, [&](auto s) {
    return gspn::launch_group_first<gspn::Ball<decltype(s)::value>, true>(
        xyz1, valid1, xyz2, nb, n, m, split, out, stream);
  });
}

// split: warps a query (1, 2, 4, 8 or 16); direct: a warp a query reading
// the scene from device memory (split 1); ballots: the wrapper's scratch of
// (b * m, nscales, gspn::strided_words(n)) words, or null for shared
// memory (ops/ball_query.py strided_plan decides all three).
extern "C" int gspn_ball_group_strided(const float* xyz1,
                                       const uint8_t* valid1,
                                       const float* xyz2, int nb, int n,
                                       int m, int nscales, const float* r2s,
                                       const int* ks, int* const* idx,
                                       int* const* cnt, float* const* local,
                                       int split, int direct,
                                       unsigned* ballots,
                                       cudaStream_t stream) {
  gspn::GroupOut out;
  const int err = gspn::ball_group_out(nscales, r2s, ks, idx, cnt, local, &out);
  if (err) return err;
  return gspn::with_scales(nscales, [&](auto s) {
    return gspn::launch_group_strided<gspn::Ball<decltype(s)::value>, true>(
        xyz1, valid1, xyz2, nb, n, m, split, direct, ballots, out, stream);
  });
}
