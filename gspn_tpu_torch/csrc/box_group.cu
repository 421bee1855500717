// S in-box scene points per RoI, for Point RoIAlign.
//
// gspn_box_group replaces gspn_tpu/ops/box_group.py::_box_kernel
// (select="first"), the Pallas kernel that reuses the ball-group chunked
// extraction with a box predicate. gspn_box_group_strided replaces
// gspn_tpu/ops/ball_group.py::_fused_kernel_strided with pred="box"
// (box_group.py, select="strided"): the in-box hits of rank
// floor(j*total/S).
//
// First-S runs group_first_kernel<Box, true> (group_first.cuh), the first-K ball
// group's scan with the inclusive test lo <= p <= hi per axis: a CTA holds
// boxes of one scene and stages the scene through shared memory in
// cp.async tiles, float4 points with NaN x where invalid (lo <= NaN is
// false), a box's scan split over 1-16 warps (8 at the flagship's 8 x 64
// boxes over 8192 points, 16 at the whole scene's 1 x 64 over 65536), and
// the scan stops once every box of the CTA holds S. Strided runs
// group_strided_kernel<Box, true> (group_strided.cuh), the strided ball group's
// kernel with the box predicate: each point tested once, the ballots kept,
// the ranks read from them. Both write coordinates relative to the box centre (lo + hi) * 0.5, rounded as
// the plain version rounds it. The caller keeps the `k mod cnt` wrap
// (models/rpointnet.py point_roi_align). What bounds both is how much of
// the scene a box must test: a box that holds fewer than S points tests
// all of it (a strided box always does).

#include "group_strided.cuh"

namespace {

gspn::GroupOut box_out(int s, int* idx, int* cnt, float* local) {
  gspn::GroupOut out{};
  out.nscales = 1;
  out.k[0] = s;
  out.r2[0] = 0.0f;
  out.idx[0] = idx;
  out.cnt[0] = cnt;
  out.local[0] = local;
  return out;
}

}  // namespace

// split: warps a box, 0 for group_first_split's choice (another value only
// to time one split against another).
extern "C" int gspn_box_group(const float* xyz1, const uint8_t* valid1,
                              const float* boxes, int nb, int n, int r, int s,
                              int* idx, int* cnt, float* local, int split,
                              cudaStream_t stream) {
  return gspn::launch_group_first<gspn::Box, true>(
      xyz1, valid1, boxes, nb, n, r, split, box_out(s, idx, cnt, local),
      stream);
}

// split, direct and ballots: as gspn_ball_group_strided's, one scale.
extern "C" int gspn_box_group_strided(const float* xyz1,
                                      const uint8_t* valid1,
                                      const float* boxes, int nb, int n,
                                      int r, int s, int* idx, int* cnt,
                                      float* local, int split, int direct,
                                      unsigned* ballots, cudaStream_t stream) {
  return gspn::launch_group_strided<gspn::Box, true>(
      xyz1, valid1, boxes, nb, n, r, split, direct, ballots,
      box_out(s, idx, cnt, local), stream);
}
