"""The stage-1 and stage-2 losses and the train step: the PyTorch
counterpart of ``gspn_tpu/train/steps.py`` (``make_gspn_loss_fn``,
``make_rpointnet_loss_fn``, ``make_train_step``, ``dp_slice``).

A :class:`TrainState` holds what the JAX package's ``TrainState`` holds:
the model (parameters and BatchNorm running statistics), the optimizer
(Adam's moments) and the update count. A step mutates it in place and
returns its metrics as 0-dim tensors on the device: nothing in a step waits
for the card, so the host runs ahead until a caller reads a metric.

The random draws of a step are the loss's keyword arguments: each is
passed in (a test feeds the JAX package's draws) or drawn from the
``generator`` in a fixed order. Stage 1: the seeds' uniforms (``seed_u``,
``seed_method="random"`` only), then the CVAE noise (``z_eps``). Stage 2:
the GT boxes' jitter (``box_noise``), the frozen GSPN's CVAE noise
(``z_eps``), the randomized RoIs' Gumbel noise (``gumbel``), then the
heads' dropout keep masks (``dropout_keep``).

A loss built with ``dp_group=`` / ``dp_size=`` is the data-parallel one
that ``parallel.dp.make_dp_train_step`` takes: each rank holds its shard
of the batch and computes the global full-batch loss, as the JAX
package's ``dp_axis`` losses do. The BatchNorm statistics and the loss's
normalizers are summed over the group's ranks, and the noise is drawn (or
passed) at the full batch's shape and sliced to the rank's rows
(``dp_slice``), so a DP step draws what the single-process step on the
whole batch draws.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from gspn_tpu_torch import ops
from gspn_tpu_torch.data.instances import gather_seed_instances
from gspn_tpu_torch.models.gspn import GSPN, gspn_loss, proposal_boxes
from gspn_tpu_torch.models.rpointnet import instance_gt_boxes, match_rois, rpointnet_loss
from gspn_tpu_torch.nn.layers import MaskedBatchNorm, cross_rank_statistics


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with ``optax.adam``'s defaults (``b1=0.9, b2=0.999,
    eps=1e-8``); the step sets the scheduled learning rate."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _check_training(model: torch.nn.Module, what: str) -> None:
    if not model.training:
        raise ValueError(f"the {what} loss runs the training forward: call model.train()")


def dp_slice(a: torch.Tensor, dp_group, dp_size: int) -> torch.Tensor:
    """This rank's rows of a full-batch-shaped draw (leading dim = local
    batch x ``dp_size``); ``a`` itself when ``dp_group`` is None."""
    if dp_group is None:
        return a
    per = a.shape[0] // dp_size
    r = dist.get_rank(dp_group)
    return a[r * per:(r + 1) * per]


def _full_batch_draw(draw, shape, dp_group, dp_size, generator, what: str, device,
                     uniform: bool = False):
    """The DP losses' noise: ``draw`` (given at the full batch's shape) or a
    draw of that shape from ``generator``, sliced to this rank's rows."""
    if draw is None:
        if generator is None:
            raise ValueError(f"pass {what} (noise) or a torch.Generator")
        fn = torch.rand if uniform else torch.randn
        draw = fn((shape[0] * dp_size, *shape[1:]), generator=generator, dtype=torch.float32,
                  device=generator.device)
    elif draw.shape[0] != shape[0] * dp_size:
        raise ValueError(f"{what} of a DP loss has the full batch's {shape[0] * dp_size} "
                         f"rows, got {tuple(draw.shape)}")
    return dp_slice(draw, dp_group, dp_size).to(device)


def make_gspn_loss_fn(num_seeds: int, gt_size: int, loss_weights: dict | None = None,
                      seed_method: str = "fps", dp_group=None, dp_size: int = 1):
    """``loss_fn(model, batch, z_eps=None, seed_u=None, generator=None) ->
    (loss, metrics)`` for a ``GSPN(cfg, recognition=True)`` in training
    mode. ``batch``: ``xyz (B,N,3)``, ``valid (B,N)`` bool, ``inst_label
    (B,N)`` int. The seeds: by FPS on the model's ``ops_impl`` (segmented
    where ``ops.eligible_fps_segments`` allows), or with ``seed_method=
    "random"`` uniformly over the valid points by ``ops.prob_sample`` at the
    uniforms ``seed_u (B, num_seeds)``. Then the seeds' GT instances
    (``gather_seed_instances``), the training forward (on the batch's
    ``features (B,N,F)`` where the model's ``feature_dim`` is above 0) and
    ``gspn_loss``.
    The CVAE noise is ``z_eps (B, num_seeds, latent)``. What is not given
    is drawn from ``generator``, the uniforms first.

    ``dp_group``/``dp_size``: the DP-aware loss (module docstring); ``batch``
    is the rank's shard, ``seed_u`` and ``z_eps`` are the full batch's."""
    lw = loss_weights or {}
    if seed_method not in ("fps", "random"):
        raise ValueError(f"seed_method must be fps|random, got {seed_method!r}")

    def loss_fn(model: GSPN, batch: dict, z_eps=None, seed_u=None, generator=None):
        _check_training(model, "GSPN")
        cfg = model.config
        xyz, valid = batch["xyz"], batch["valid"]
        if dp_group is not None:
            b = xyz.shape[0]
            if seed_method == "random":
                seed_u = _full_batch_draw(seed_u, (b, num_seeds), dp_group, dp_size,
                                          generator, "seed_u", xyz.device, uniform=True)
            z_eps = _full_batch_draw(z_eps, (b, num_seeds, cfg.latent_dim), dp_group, dp_size,
                                     generator, "z_eps", xyz.device)
        if seed_method == "random":
            weights = valid.to(torch.float32)
            if seed_u is not None:
                seed_idx = ops.prob_sample(weights, seed_u)
            elif generator is not None:
                seed_idx = ops.random_prob_sample(weights, num_seeds, generator)
            else:
                raise ValueError("pass seed_u (uniforms) or a torch.Generator")
        else:
            seed_idx = ops.farthest_point_sample(
                num_seeds, xyz, valid, impl=cfg.ops_impl,
                segments=ops.eligible_fps_segments(cfg.fps_segments, num_seeds, xyz.shape[1]),
                segment_mode=cfg.fps_segment_mode,
            )
        gt_points, gt_valid, gt_center, is_fg = gather_seed_instances(
            xyz, batch["inst_label"], seed_idx, gt_size
        )
        with cross_rank_statistics(model, dp_group):
            out = model(xyz, seed_idx, valid, z_eps=z_eps, generator=generator,
                        gt_points=gt_points, gt_valid=gt_valid, features=batch.get("features"))
        return gspn_loss(out, gt_points, gt_valid, gt_center, is_fg, impl=cfg.ops_impl,
                         group=dp_group, **lw)

    loss_fn.dp_group, loss_fn.dp_size = dp_group, dp_size
    return loss_fn


# the GT boxes' jitter, in metres: the JAX package's default, which its
# trainer and bench use
GT_BOX_JITTER = 0.05


def make_rpointnet_loss_fn(max_instances: int, frozen_gspn: tuple | None = None,
                           mix_gt_boxes: bool = True, dp_group=None, dp_size: int = 1):
    """``loss_fn(model, batch, box_noise=None, z_eps=None, gumbel=None,
    dropout_keep=None, generator=None) -> (loss, metrics)`` for an
    ``RPointNet`` in training mode. ``batch``: ``xyz``, ``valid``,
    ``inst_label`` and ``sem_label`` (B,N).

    The GT boxes (``instance_gt_boxes`` over ``max_instances``) jittered by
    ``GT_BOX_JITTER * box_noise`` (``box_noise (B, max_instances, 6)``
    N(0,1)) are the RoIs, or, with ``frozen_gspn = (GSPN, num_seeds)`` (an
    inference GSPN, put in eval mode here and run under ``torch.no_grad``),
    the boxes of its proposals at ``num_seeds`` FPS seeds (CVAE noise
    ``z_eps``), followed by the jittered GT boxes when ``mix_gt_boxes``. One
    FPS pass of ``max(num_seeds, sa1 npoint)`` picks on the model's
    ``ops_impl`` gives both the seeds and SA1's centres (greedy FPS is
    prefix-consistent; the JAX package's ``share_fps=True``, what its
    trainer and bench run). Then the training forward (``gumbel`` and
    ``dropout_keep``: ``RPointNet.forward``; both stages read the batch's
    ``features`` where their ``feature_dim`` is above 0), the IoU match (in GT-box mode
    only RoIs of present instances count) and ``rpointnet_loss``. What is
    not given is drawn from ``generator``, in the module docstring's
    order.

    ``dp_group``/``dp_size``: the DP-aware loss (module docstring); ``batch``
    is the rank's shard, ``box_noise`` and ``z_eps`` the full batch's. It
    refuses a model with ``head_dropout > 0`` or ``roi_randomize``, as the
    JAX package's does: their draws' shapes are the shard's, so they could
    not match the single-process draws."""
    if frozen_gspn is not None:
        frozen_gspn[0].eval()

    def loss_fn(model, batch: dict, box_noise=None, z_eps=None, gumbel=None,
                dropout_keep=None, generator=None):
        _check_training(model, "R-PointNet")
        cfg = model.config
        xyz, valid, features = batch["xyz"], batch["valid"], batch.get("features")
        gt_boxes, gt_cls, present = instance_gt_boxes(
            xyz, batch["inst_label"], batch["sem_label"], max_instances)
        if dp_group is not None:
            if cfg.head_dropout > 0 or cfg.roi_randomize:
                raise ValueError(
                    "the DP-aware stage-2 loss does not support head_dropout > 0 or "
                    "roi_randomize: their per-rank draws cannot match the single-process "
                    "full-batch draws; set head_dropout=0 and roi_randomize=False")
            box_noise = _full_batch_draw(box_noise, tuple(gt_boxes.shape), dp_group, dp_size,
                                         generator, "box_noise", xyz.device)
            if frozen_gspn is not None:
                z_eps = _full_batch_draw(
                    z_eps, (xyz.shape[0], frozen_gspn[1], frozen_gspn[0].config.latent_dim),
                    dp_group, dp_size, generator, "z_eps", xyz.device)
        if box_noise is None:
            if generator is None:
                raise ValueError("pass box_noise (noise) or a torch.Generator")
            box_noise = torch.randn(gt_boxes.shape, generator=generator, dtype=torch.float32,
                                    device=generator.device)
        noise = box_noise.to(xyz.device) * GT_BOX_JITTER
        gt_rois = torch.where(present[..., None], gt_boxes + noise, torch.zeros_like(gt_boxes))
        sa1_fps_idx = None
        if frozen_gspn is not None:
            gmodel, num_seeds = frozen_gspn
            sa1_n = cfg.sa_layers[0].npoint
            fps_all = ops.farthest_point_sample(
                max(num_seeds, sa1_n), xyz, valid, impl=cfg.ops_impl,
                segments=ops.shared_eligible_fps_segments(
                    cfg.fps_segments, (num_seeds, sa1_n), xyz.shape[1]),
                segment_mode=cfg.fps_segment_mode)
            seed_idx, sa1_fps_idx = fps_all[:, :num_seeds], fps_all[:, :sa1_n]
            with torch.no_grad():
                gout = gmodel(xyz, seed_idx, valid, z_eps=z_eps, generator=generator,
                              features=features)
                rois = proposal_boxes(gout.generated, cfg.box_margin)
            if mix_gt_boxes:
                rois = torch.cat([rois, gt_rois], dim=1)
        else:
            rois = gt_rois
        with cross_rank_statistics(model, dp_group):
            out = model(xyz, rois, valid, sa1_fps_idx=sa1_fps_idx, gumbel=gumbel,
                        dropout_keep=dropout_keep, generator=generator, features=features)
        roi_valid = out.roi_valid & present if frozen_gspn is None else out.roi_valid
        match = match_rois(rois, roi_valid, gt_boxes, gt_cls, present, cfg.fg_iou, cfg.bg_iou)
        return rpointnet_loss(out, match, batch["inst_label"], group=dp_group)

    loss_fn.dp_group, loss_fn.dp_size = dp_group, dp_size
    return loss_fn


def set_bn_momentum(model: torch.nn.Module, momentum: float) -> None:
    for mod in model.modules():
        if isinstance(mod, MaskedBatchNorm):
            mod.momentum = momentum


def make_train_step(loss_fn, lr_schedule=None, bn_momentum_fn=None, combine_grads=None):
    """``step(state, batch, **draws) -> metrics``: the learning rate
    ``lr_schedule(state.step)`` and the BatchNorm momentum
    ``bn_momentum_fn(state.step)`` (each at the count before the update, as
    optax evaluates a schedule), zero the gradients, the loss (``draws``
    passed on: the noise and the ``generator``) and its backward,
    ``combine_grads(model)`` where given (the DP step's cross-rank mean), one
    optimizer step, then ``state.step += 1``."""

    def step(state: TrainState, batch: dict, **draws) -> dict:
        if lr_schedule is not None:
            lr = lr_schedule(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
        if bn_momentum_fn is not None:
            set_bn_momentum(state.model, bn_momentum_fn(state.step))
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(state.model, batch, **draws)
        total.backward()
        if combine_grads is not None:
            combine_grads(state.model)
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step
