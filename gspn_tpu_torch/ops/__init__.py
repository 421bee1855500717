"""Point-cloud op library: the PyTorch counterpart of ``gspn_tpu.ops``.

Ops with a hand-written Hopper kernel (``farthest_point_sample``,
``query_ball_group_multi`` and ``query_box_group`` with ``select`` "first"
or "strided", ``query_ball_point(_multi)``, ``three_nn``,
``three_interpolate_mm``, ``nearest_sample_logit``,
``nearest_sample_logit_boxed``, ``nms_3d(_batched)``, ``nn_argmin`` under
``nn_distance``) take
``impl="auto|cuda|plain"`` (see ``ops/common.py``); each kernel counts its
launches in ``KERNELS[name].launches``.
"""

from gspn_tpu_torch.ops._cuda import KERNELS, launch_counts, reset_launch_counts
from gspn_tpu_torch.ops.ball_group import query_ball_group_multi
from gspn_tpu_torch.ops.ball_query import (
    ball_query_plain,
    query_ball_point,
    query_ball_point_multi,
)
from gspn_tpu_torch.ops.box_group import box_contains, query_box_group
from gspn_tpu_torch.ops.chamfer import chamfer_loss, nn_argmin, nn_distance
from gspn_tpu_torch.ops.common import masked_sqdist, pairwise_sqdist, resolve_impl, round_up
from gspn_tpu_torch.ops.fps import (
    eligible_fps_segments,
    farthest_point_sample,
    shared_eligible_fps_segments,
    spatial_sorted_view,
)
from gspn_tpu_torch.ops.grouping import gather_point, group_point
from gspn_tpu_torch.ops.interpolate import (
    three_interpolate,
    three_interpolate_mm,
    three_interpolate_weights,
    three_nn,
)
from gspn_tpu_torch.ops.mask_project import (
    nearest_sample_logit,
    nearest_sample_logit_boxed,
    tile_relevance,
)
from gspn_tpu_torch.ops.morton import morton_codes, spatial_order
from gspn_tpu_torch.ops.nms import box_iou, box_volume, nms_3d, nms_3d_batched

__all__ = [
    "KERNELS",
    "ball_query_plain",
    "box_contains",
    "box_iou",
    "box_volume",
    "chamfer_loss",
    "eligible_fps_segments",
    "farthest_point_sample",
    "gather_point",
    "group_point",
    "launch_counts",
    "masked_sqdist",
    "morton_codes",
    "nearest_sample_logit",
    "nearest_sample_logit_boxed",
    "nn_argmin",
    "nn_distance",
    "nms_3d",
    "nms_3d_batched",
    "pairwise_sqdist",
    "query_ball_group_multi",
    "query_ball_point",
    "query_ball_point_multi",
    "query_box_group",
    "reset_launch_counts",
    "resolve_impl",
    "round_up",
    "shared_eligible_fps_segments",
    "spatial_order",
    "spatial_sorted_view",
    "three_interpolate",
    "three_interpolate_mm",
    "three_interpolate_weights",
    "three_nn",
    "tile_relevance",
]
