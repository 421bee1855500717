// S in-box scene points per RoI, for Point RoIAlign.
//
// gspn_box_group replaces gspn_tpu/ops/box_group.py::_box_kernel
// (select="first"), the Pallas kernel that reuses the ball-group chunked
// extraction with a box predicate. gspn_box_group_strided replaces
// gspn_tpu/ops/ball_group.py::_fused_kernel_strided with pred="box"
// (box_group.py, select="strided"): the in-box hits of rank
// floor(j*total/S).
//
// Same warp-per-query scan as the ball group (group_scan.cuh) with the
// inclusive test lo <= p <= hi per axis and coordinates relative to the box
// centre (lo + hi) * 0.5. The caller keeps the `k mod cnt` wrap
// (models/rpointnet.py point_roi_align). What bounds it is how much of the
// scene a box must scan: first-S stops once it holds S points (a box that
// holds fewer reads the whole L2-resident scene), strided reads it twice.

#include "group_scan.cuh"

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

extern "C" int gspn_box_group(const float* xyz1, const uint8_t* valid1,
                              const float* boxes, int nb, int n, int r, int s,
                              int* idx, int* cnt, float* local,
                              cudaStream_t stream) {
  return gspn::launch_group_scan<true, false, true>(
      xyz1, valid1, boxes, nb, n, r, box_out(s, idx, cnt, local), stream);
}

extern "C" int gspn_box_group_strided(const float* xyz1,
                                      const uint8_t* valid1,
                                      const float* boxes, int nb, int n,
                                      int r, int s, int* idx, int* cnt,
                                      float* local, cudaStream_t stream) {
  return gspn::launch_group_scan<true, true, true>(
      xyz1, valid1, boxes, nb, n, r, box_out(s, idx, cnt, local), stream);
}
