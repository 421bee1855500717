"""Point-cloud op library: the PyTorch counterpart of ``gspn_tpu.ops``.

Ops with a hand-written Hopper kernel (``farthest_point_sample``,
``query_ball_group_multi`` and ``query_box_group`` with ``select`` "first"
or "strided", ``query_ball_point(_multi)``, ``three_nn``,
``three_interpolate_mm`` and ``three_interpolate_fp``,
``nearest_sample_logit``, ``nearest_sample_logit_boxed``,
``nms_3d(_batched)``, ``nn_argmin`` and ``nn_argmin_pair`` (under
``nn_distance``), ``index_add_rows``, the deterministic backward of
``gather_point`` / ``group_point``, and the training-mode BatchNorm with
its ReLU, ``batch_norm_train``: ``batch_norm_stats``, ``batch_norm_apply``
and its backward, ``batch_norm_grad_terms`` and ``batch_norm_grad_input``) take
``impl="auto|cuda|plain"`` (see ``ops/common.py``); each kernel counts its
launches in ``KERNELS[name].launches``. Each of them but the BatchNorm's
calls its kernel (or its plain version) through one op of the ``gspn``
namespace (``common.gspn_op``), so ``torch.export`` keeps the call as one
opaque node (``serve/export.py``); eager calls take the same op. The
BatchNorm's four are plain functions under ``batch_norm_train``'s
``torch.autograd.Function``: only a training step calls them, and an
export traces eval mode.
"""

from gspn_tpu_torch.ops._cuda import KERNELS, launch_counts, reset_launch_counts
from gspn_tpu_torch.ops.ball_group import query_ball_group_multi
from gspn_tpu_torch.ops.ball_query import (
    ball_query_plain,
    query_ball_point,
    query_ball_point_multi,
)
from gspn_tpu_torch.ops.batchnorm import (
    batch_norm_apply,
    batch_norm_grad_input,
    batch_norm_grad_terms,
    batch_norm_stats,
    batch_norm_train,
)
from gspn_tpu_torch.ops.box_group import box_contains, query_box_group
from gspn_tpu_torch.ops.chamfer import chamfer_loss, nn_argmin, nn_argmin_pair, nn_distance
from gspn_tpu_torch.ops.common import masked_sqdist, pairwise_sqdist, resolve_impl, round_up
from gspn_tpu_torch.ops.fps import (
    eligible_fps_segments,
    farthest_point_sample,
    shared_eligible_fps_segments,
    spatial_sorted_view,
)
from gspn_tpu_torch.ops.grouping import gather_point, group_point, index_add_rows, knn_point
from gspn_tpu_torch.ops.interpolate import (
    three_interpolate,
    three_interpolate_fp,
    three_interpolate_mm,
    three_interpolate_weights,
    three_nn,
)
from gspn_tpu_torch.ops.mask_project import (
    nearest_sample_logit,
    nearest_sample_logit_boxed,
    tile_relevance,
)
from gspn_tpu_torch.ops.morton import apply_order, morton_codes, spatial_order
from gspn_tpu_torch.ops.nms import box_iou, box_volume, nms_3d, nms_3d_batched
from gspn_tpu_torch.ops.sampling import prob_sample, random_prob_sample

__all__ = [
    "KERNELS",
    "apply_order",
    "ball_query_plain",
    "batch_norm_apply",
    "batch_norm_grad_input",
    "batch_norm_grad_terms",
    "batch_norm_stats",
    "batch_norm_train",
    "box_contains",
    "box_iou",
    "box_volume",
    "chamfer_loss",
    "eligible_fps_segments",
    "farthest_point_sample",
    "gather_point",
    "group_point",
    "index_add_rows",
    "knn_point",
    "launch_counts",
    "masked_sqdist",
    "morton_codes",
    "nearest_sample_logit",
    "nearest_sample_logit_boxed",
    "nn_argmin",
    "nn_argmin_pair",
    "nn_distance",
    "nms_3d",
    "nms_3d_batched",
    "pairwise_sqdist",
    "prob_sample",
    "query_ball_group_multi",
    "query_ball_point",
    "query_ball_point_multi",
    "query_box_group",
    "random_prob_sample",
    "reset_launch_counts",
    "resolve_impl",
    "round_up",
    "shared_eligible_fps_segments",
    "spatial_order",
    "spatial_sorted_view",
    "three_interpolate",
    "three_interpolate_fp",
    "three_interpolate_mm",
    "three_interpolate_weights",
    "three_nn",
    "tile_relevance",
]
