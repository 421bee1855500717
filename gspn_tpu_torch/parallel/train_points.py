"""Point-sharded training: the PyTorch counterpart of
``gspn_tpu/parallel/train_points.py``. Where ``parallel/dp.py`` splits the
batch, here the work inside each scene shards over the ranks of a
:class:`PointMesh` row:

- stage 1 (the GSPN CVAE): the seeds, each rank cropping, encoding and
  decoding its slice;
- stage 2 (R-PointNet): the frozen GSPN's seeds (its proposals
  all-gathered), the backbone on points (``points.sharded_backbone_body``)
  and RoIAlign and the heads on RoIs.

On a 2-D mesh the scenes also split over the rows. Every rank passes the
whole batch and takes its row's scenes.

The sharded step computes the single-process step on the whole batch, up
to the order of float sums: the loss's normalizers and numerators and
every BatchNorm's training statistics are summed over all the ranks (the
world group: both axes), and the noise (the seeds' uniforms, the CVAE
noise, the GT boxes' jitter) is drawn, or passed, at the whole batch's
shape and sliced (``train.steps._full_batch_draw``). Every rank then holds
the same global loss, and since the collectives' backwards sum every
rank's output gradient (``nn.layers.all_reduce_sum``,
``nn.layers.all_gather_tiled``), each rank's gradient is the world size
times its share of the global one: their mean
(``dp.mean_gradients``) is the global gradient, the JAX package's
``pmean``. Draws whose shapes are a rank's (head dropout, randomized RoI
sampling) could not match the single process's, so the factories refuse
them, as the JAX package does.
"""

from __future__ import annotations

import torch

from gspn_tpu_torch import ops
from gspn_tpu_torch.data.instances import gather_seed_instances
from gspn_tpu_torch.models.gspn import gspn_loss, proposal_boxes
from gspn_tpu_torch.models.rpointnet import instance_gt_boxes, match_rois, rpointnet_loss
from gspn_tpu_torch.nn.layers import all_gather_tiled, cross_rank_statistics
from gspn_tpu_torch.parallel.dp import mean_gradients
from gspn_tpu_torch.parallel.mesh import PointMesh
from gspn_tpu_torch.parallel.points import (
    check_divisible,
    scene_rows,
    shard_slice,
    sharded_backbone_body,
)
from gspn_tpu_torch.train.steps import (
    GT_BOX_JITTER,
    _check_training,
    _full_batch_draw,
    make_train_step,
)


def _check_config(model, cfg) -> None:
    if model.config != cfg:
        raise ValueError("the model was built from another config than this point-sharded "
                         "loss's; build it from the same config")


def make_point_sharded_train_step(loss_fn, mesh: PointMesh, lr_schedule=None,
                                  bn_momentum_fn=None):
    """``step(state, batch, **draws) -> metrics`` on the whole ``batch``, as
    ``train.steps.make_train_step``, with the gradients averaged over the
    mesh's ranks before the optimizer step. ``loss_fn``: one of this
    module's point-sharded losses for ``mesh``."""
    if getattr(loss_fn, "point_mesh", None) is not mesh:
        raise ValueError("make_point_sharded_train_step takes a point-sharded loss of the same "
                         "mesh: make_point_sharded_gspn_loss_fn/"
                         "make_point_sharded_rpointnet_loss_fn(..., mesh)")
    return make_train_step(loss_fn, lr_schedule, bn_momentum_fn,
                           combine_grads=mean_gradients(mesh.world, mesh.size))


def make_point_sharded_gspn_loss_fn(cfg, mesh: PointMesh, num_seeds: int, gt_size: int,
                                    loss_weights: dict | None = None, seed_method: str = "fps"):
    """``loss_fn(model, batch, z_eps=None, seed_u=None, generator=None) ->
    (loss, metrics)``: ``train.steps.make_gspn_loss_fn``'s loss with the
    seeds sharded over ``mesh.space`` (``num_seeds`` must divide by the
    row's ranks) for a ``GSPN(cfg, recognition=True)`` in training mode.
    ``batch`` is the whole batch, ``seed_u`` and ``z_eps`` the whole
    batch's draws (else drawn from ``generator`` in that order). The
    seeds' FPS (or ``seed_method="random"``'s draw, on a 1-D mesh only) is
    replicated."""
    check_divisible("num_seeds", num_seeds, mesh.n_space)
    if seed_method not in ("fps", "random"):
        raise ValueError(f"seed_method must be fps|random, got {seed_method}")
    if seed_method == "random" and mesh.n_data > 1:
        raise ValueError("seed_method='random' draws over the full batch and cannot bit-match "
                         "with scenes sharded over a data axis; use 'fps' or a 1-D mesh")
    lw = loss_weights or {}
    i, nshards = mesh.space_index, mesh.n_space

    def loss_fn(model, batch: dict, z_eps=None, seed_u=None, generator=None):
        _check_training(model, "GSPN")
        _check_config(model, cfg)
        xyz, valid, inst, features = scene_rows(mesh, batch["xyz"], batch["valid"],
                                                batch["inst_label"], batch.get("features"))
        b = xyz.shape[0]
        if seed_method == "random":
            seed_u = _full_batch_draw(seed_u, (b, num_seeds), None, 1, generator, "seed_u",
                                      xyz.device, uniform=True)
            seed_idx = ops.prob_sample(valid.to(torch.float32), seed_u)
        else:
            seed_idx = ops.farthest_point_sample(
                num_seeds, xyz, valid, impl=cfg.ops_impl,
                segments=ops.eligible_fps_segments(cfg.fps_segments, num_seeds, xyz.shape[1]),
                segment_mode=cfg.fps_segment_mode,
            )
        z_eps = _full_batch_draw(z_eps, (b, num_seeds, cfg.latent_dim), mesh.data, mesh.n_data,
                                 generator, "z_eps", xyz.device)
        my_seeds = shard_slice(seed_idx, i, nshards)
        gt_points, gt_valid, gt_center, is_fg = gather_seed_instances(xyz, inst, my_seeds,
                                                                      gt_size)
        with cross_rank_statistics(model, mesh.world):
            out = model(xyz, my_seeds, valid, z_eps=shard_slice(z_eps, i, nshards),
                        gt_points=gt_points, gt_valid=gt_valid, features=features)
        return gspn_loss(out, gt_points, gt_valid, gt_center, is_fg, impl=cfg.ops_impl,
                         group=mesh.world, **lw)

    loss_fn.point_mesh = mesh
    return loss_fn


def make_point_sharded_gspn_train_step(cfg, mesh: PointMesh, num_seeds: int, gt_size: int,
                                       loss_weights: dict | None = None,
                                       seed_method: str = "fps", lr_schedule=None,
                                       bn_momentum_fn=None):
    """The seed-sharded stage-1 step (:func:`make_point_sharded_gspn_loss_fn`
    in :func:`make_point_sharded_train_step`): the single-process step of
    ``make_gspn_loss_fn`` on the whole batch, to float tolerance."""
    loss_fn = make_point_sharded_gspn_loss_fn(cfg, mesh, num_seeds, gt_size, loss_weights,
                                              seed_method)
    return make_point_sharded_train_step(loss_fn, mesh, lr_schedule, bn_momentum_fn)


def make_point_sharded_rpointnet_loss_fn(cfg, mesh: PointMesh, max_instances: int,
                                         frozen_gspn: tuple | None = None,
                                         loss_weights: dict | None = None,
                                         gt_box_jitter: float = GT_BOX_JITTER,
                                         mix_gt_boxes: bool = True):
    """``loss_fn(model, batch, box_noise=None, z_eps=None, generator=None) ->
    (loss, metrics)``: ``train.steps.make_rpointnet_loss_fn``'s loss with
    the frozen GSPN's seeds, the backbone's points and the RoIs sharded over
    ``mesh.space``, for an ``RPointNet(cfg)`` in training mode.
    ``frozen_gspn = (GSPN, num_seeds)``, ``loss_weights`` and
    ``gt_box_jitter`` as there (the FPS pass is shared). ``batch`` is the whole
    batch, ``box_noise`` and ``z_eps`` the whole batch's draws (else drawn
    from ``generator`` in that order).

    N, sa1's ``npoint``, ``num_seeds`` and the RoIs a scene
    (``num_seeds + max_instances`` with GT mixing, else ``max_instances``)
    must divide by the row's ranks. Refuses ``head_dropout > 0`` and
    ``roi_randomize``."""
    nshards, i = mesh.n_space, mesh.space_index
    if cfg.head_dropout > 0:
        raise ValueError("point-sharded training does not support head_dropout>0 (per-shard "
                         "dropout shapes cannot match the single-device draw); set "
                         "head_dropout=0")
    if cfg.roi_randomize:
        raise ValueError("point-sharded training does not support roi_randomize (per-shard "
                         "Gumbel shapes cannot match the single-device draw); use the "
                         "deterministic first-S RoI sampling")
    check_divisible("sa1 npoint", cfg.sa_layers[0].npoint, nshards)
    r_total = max_instances
    if frozen_gspn is not None:
        gmodel, num_seeds = frozen_gspn
        gmodel.eval()
        check_divisible("num_seeds", num_seeds, nshards)
        r_total = num_seeds + (max_instances if mix_gt_boxes else 0)
    check_divisible("total RoIs", r_total, nshards)
    lw = loss_weights or {}

    def loss_fn(model, batch: dict, box_noise=None, z_eps=None, generator=None):
        _check_training(model, "R-PointNet")
        _check_config(model, cfg)
        xyz, valid, inst, sem, features = scene_rows(
            mesh, batch["xyz"], batch["valid"], batch["inst_label"], batch["sem_label"],
            batch.get("features"))
        gt_boxes, gt_cls, present = instance_gt_boxes(xyz, inst, sem, max_instances)
        box_noise = _full_batch_draw(box_noise, tuple(gt_boxes.shape), mesh.data, mesh.n_data,
                                     generator, "box_noise", xyz.device)
        gt_rois = torch.where(present[..., None], gt_boxes + box_noise * gt_box_jitter,
                              torch.zeros_like(gt_boxes))
        sa1_fps_idx = None
        if frozen_gspn is not None:
            z_eps = _full_batch_draw(z_eps, (xyz.shape[0], num_seeds, gmodel.config.latent_dim),
                                     mesh.data, mesh.n_data, generator, "z_eps", xyz.device)
            sa1_n = cfg.sa_layers[0].npoint
            fps_all = ops.farthest_point_sample(
                max(num_seeds, sa1_n), xyz, valid, impl=cfg.ops_impl,
                segments=ops.shared_eligible_fps_segments(
                    cfg.fps_segments, (num_seeds, sa1_n), xyz.shape[1]),
                segment_mode=cfg.fps_segment_mode)
            sa1_fps_idx = fps_all[:, :sa1_n]
            with torch.no_grad():
                gout = gmodel(xyz, shard_slice(fps_all[:, :num_seeds], i, nshards), valid,
                              z_eps=shard_slice(z_eps, i, nshards), features=features)
                props = all_gather_tiled(proposal_boxes(gout.generated, cfg.box_margin), 1,
                                         mesh.space)
            rois = torch.cat([props, gt_rois], dim=1) if mix_gt_boxes else props
        else:
            rois = gt_rois
        my_rois = shard_slice(rois, i, nshards)
        with cross_rank_statistics(model, mesh.world):
            feat_l = sharded_backbone_body(model.backbone, mesh, xyz, valid,
                                           sa1_fps_idx=sa1_fps_idx, features=features)
            feat = all_gather_tiled(feat_l, 1, mesh.space)
            out = model.roi_forward(xyz, feat, my_rois, valid)
        roi_valid = out.roi_valid
        if frozen_gspn is None:
            roi_valid = roi_valid & shard_slice(present, i, nshards)
        match = match_rois(my_rois, roi_valid, gt_boxes, gt_cls, present, cfg.fg_iou,
                           cfg.bg_iou)
        return rpointnet_loss(out, match, inst, group=mesh.world, **lw)

    loss_fn.point_mesh = mesh
    return loss_fn


def make_point_sharded_rpointnet_train_step(cfg, mesh: PointMesh, max_instances: int,
                                            frozen_gspn: tuple | None = None,
                                            loss_weights: dict | None = None,
                                            gt_box_jitter: float = GT_BOX_JITTER,
                                            mix_gt_boxes: bool = True, lr_schedule=None,
                                            bn_momentum_fn=None):
    """The fully sharded stage-2 step
    (:func:`make_point_sharded_rpointnet_loss_fn` in
    :func:`make_point_sharded_train_step`): the single-process step of
    ``make_rpointnet_loss_fn`` on the whole batch, to float tolerance."""
    loss_fn = make_point_sharded_rpointnet_loss_fn(cfg, mesh, max_instances, frozen_gspn,
                                                   loss_weights, gt_box_jitter, mix_gt_boxes)
    return make_point_sharded_train_step(loss_fn, mesh, lr_schedule, bn_momentum_fn)
