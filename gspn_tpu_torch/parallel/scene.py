"""Point-sharded whole-scene inference: the PyTorch counterpart of
``gspn_tpu/parallel/scene.py``. Every N- and R-proportional stage of the
pipeline shards over the ranks of a :class:`PointMesh` row:

- FPS: global and sequential, replicated; one pass serves the seeds and
  the backbone's sa1, as in the single-process pipeline;
- GSPN: each rank crops, encodes and decodes its slice of the seeds; the
  proposal boxes and objectness are all-gathered;
- NMS: replicated on the gathered proposals (the card's kernel);
- backbone: point-sharded (``points.sharded_backbone_body``); its final
  map is all-gathered once, since the RoI stage reads features at any
  point;
- RoIAlign, the heads and the mask projection: each rank's slice of the
  RoIs over all N points.

On a 2-D mesh the scenes also split over the rows; every collective of the
body runs within a row. The ranks' predictions are gathered back, so every
rank returns the whole batch's. Against the single-process pipeline,
indices, counts, classes and validity are exact; the masks and scores ride
the backbone map, which agrees to float tolerance (a rank's MLP batch
shapes reorder sums), so a mask bit can flip only where its logit sits
within rounding of the threshold.
"""

from __future__ import annotations

import torch

from gspn_tpu_torch import ops
from gspn_tpu_torch.models.gspn import proposal_boxes
from gspn_tpu_torch.models.pipeline import (
    PipelineConfig,
    check_model,
    check_supported,
    instance_predictions,
    shared_fps_indices_view,
)
from gspn_tpu_torch.nn.layers import all_gather_tiled
from gspn_tpu_torch.parallel.mesh import PointMesh
from gspn_tpu_torch.parallel.points import (
    check_divisible,
    check_seed_count,
    reassemble,
    scene_rows,
    shard_slice,
    sharded_backbone_body,
)


def sharded_proposals(cfg: PipelineConfig, model, mesh: PointMesh, xyz, valid, z_eps,
                      features=None):
    """The seeds' replicated FPS pass and the GSPN on this rank's slice of
    the seeds (and of the noise ``z_eps (B, num_seeds, latent)``): ``(sa1
    FPS centres or None, all-gathered boxes (B,R,6), their objectness,
    NMS keep)``, the same on every rank of the row."""
    nshards, i = mesh.n_space, mesh.space_index
    seed_idx, sa1_idx, _ = shared_fps_indices_view(cfg, xyz, valid)
    gout = model.gspn(xyz, shard_slice(seed_idx, i, nshards), valid,
                      z_eps=shard_slice(z_eps, i, nshards), features=features)
    boxes_l = proposal_boxes(gout.generated, cfg.rpointnet.box_margin, cfg.box_percentile)
    boxes = all_gather_tiled(boxes_l, 1, mesh.space)
    obj = all_gather_tiled(torch.sigmoid(gout.objectness), 1, mesh.space)
    keep = ops.nms_3d_batched(boxes, obj, cfg.rpointnet.nms_iou, impl=cfg.rpointnet.ops_impl)
    return sa1_idx, boxes, obj, keep


def make_point_sharded_inference(cfg: PipelineConfig, mesh: PointMesh):
    """Returns ``infer(model, xyz, valid, z_eps, features=None) ->
    InstancePredictions`` for a ``PipelineModel`` of ``cfg`` in eval mode,
    with points, seeds and RoIs sharded over ``mesh.space`` and, on a 2-D
    mesh, the scenes over its rows (the batch must split over them). Every
    rank passes the whole batch and the same ``z_eps (B, num_seeds,
    latent)``, so a sharded and a single-process run can share their noise,
    and gets the whole batch's predictions. ``cfg.num_seeds``, sa1's
    ``npoint`` and N must divide by the row's ranks; ``features (B, N, F)``
    go to both stages where the configs' ``feature_dim`` is above 0. The
    masks are projected without the sorted view (the same masks)."""
    check_supported(cfg)
    check_seed_count(cfg, mesh)
    check_divisible("sa1 npoint", cfg.rpointnet.sa_layers[0].npoint, mesh.n_space)
    nshards, i = mesh.n_space, mesh.space_index

    def infer(model, xyz, valid, z_eps, features=None):
        check_model(cfg, model)
        xyz, valid, z_eps, features = scene_rows(mesh, xyz, valid, z_eps, features)
        sa1_idx, boxes, obj, keep = sharded_proposals(cfg, model, mesh, xyz, valid, z_eps,
                                                      features)
        rpn = model.rpointnet
        feat_l = sharded_backbone_body(rpn.backbone, mesh, xyz, valid, sa1_fps_idx=sa1_idx,
                                       features=features)
        feat = all_gather_tiled(feat_l, 1, mesh.space)
        my_boxes = shard_slice(boxes, i, nshards)
        out = rpn.roi_forward(xyz, feat, my_boxes, valid)
        preds = instance_predictions(cfg, xyz, valid, my_boxes, shard_slice(obj, i, nshards),
                                     shard_slice(keep, i, nshards), out)
        return reassemble(preds, mesh)

    return infer
