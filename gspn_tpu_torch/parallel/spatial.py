"""Seed- and RoI-sharded inference: the PyTorch counterpart of
``gspn_tpu/parallel/spatial.py``. One scene's per-seed work (the context
crops and the CVAE decode) and per-RoI work (RoIAlign, the heads and the
mask projection) shard over the ranks of a :class:`PointMesh` row; the
coordinates and the backbone are replicated. NMS needs every proposal, so
the boxes and objectness are all-gathered and suppression runs
replicated. With the same noise, masks, classes and validity equal the
single-process pipeline's; scores agree to float tolerance (a rank's
seed slice changes the MLPs' batch shapes)."""

from __future__ import annotations

from gspn_tpu_torch.models.pipeline import (
    PipelineConfig,
    check_model,
    check_supported,
    instance_predictions,
)
from gspn_tpu_torch.parallel.mesh import PointMesh
from gspn_tpu_torch.parallel.points import check_seed_count, reassemble, scene_rows, shard_slice
from gspn_tpu_torch.parallel.scene import sharded_proposals


def make_spatial_inference(cfg: PipelineConfig, mesh: PointMesh):
    """Returns ``infer(model, xyz, valid, z_eps, features=None) ->
    InstancePredictions`` (the arguments as
    ``scene.make_point_sharded_inference``'s) with the seeds and RoIs
    sharded over ``mesh.space`` and the backbone run whole on every rank;
    ``cfg.num_seeds`` must divide by the row's ranks."""
    check_supported(cfg)
    check_seed_count(cfg, mesh)
    nshards, i = mesh.n_space, mesh.space_index

    def infer(model, xyz, valid, z_eps, features=None):
        check_model(cfg, model)
        xyz, valid, z_eps, features = scene_rows(mesh, xyz, valid, z_eps, features)
        sa1_idx, boxes, obj, keep = sharded_proposals(cfg, model, mesh, xyz, valid, z_eps,
                                                      features)
        my_boxes = shard_slice(boxes, i, nshards)
        out = model.rpointnet(xyz, my_boxes, valid, sa1_fps_idx=sa1_idx, features=features)
        preds = instance_predictions(cfg, xyz, valid, my_boxes, shard_slice(obj, i, nshards),
                                     shard_slice(keep, i, nshards), out)
        return reassemble(preds, mesh)

    return infer
