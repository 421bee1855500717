"""The GSPN stage-1 loss and train step: the PyTorch counterpart of
``gspn_tpu/train/steps.py`` (``make_gspn_loss_fn``, ``make_train_step``).

A :class:`TrainState` holds what the JAX package's ``TrainState`` holds:
the model (parameters and BatchNorm running statistics), the optimizer
(Adam's moments) and the update count. A step mutates it in place and
returns its metrics as 0-dim tensors on the device: nothing in a step waits
for the card, so the host runs ahead until a caller reads a metric.
"""

from __future__ import annotations

import dataclasses

import torch

from gspn_tpu_torch import ops
from gspn_tpu_torch.data.instances import gather_seed_instances
from gspn_tpu_torch.models.gspn import GSPN, gspn_loss, not_ported
from gspn_tpu_torch.nn.layers import MaskedBatchNorm

TRAINING = "Training"  # ROADMAP.md entry of the training code still to port


@dataclasses.dataclass
class TrainState:
    model: GSPN
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with ``optax.adam``'s defaults (``b1=0.9, b2=0.999,
    eps=1e-8``); the step sets the scheduled learning rate."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_gspn_loss_fn(num_seeds: int, gt_size: int, loss_weights: dict | None = None,
                      seed_method: str = "fps"):
    """``loss_fn(model, batch, z_eps=None, generator=None) -> (loss,
    metrics)`` for a ``GSPN(cfg, recognition=True)`` in training mode.
    ``batch``: ``xyz (B,N,3)``, ``valid (B,N)`` bool, ``inst_label (B,N)``
    int. Seeds by FPS on the model's ``ops_impl`` (segmented where
    ``ops.eligible_fps_segments`` allows), the seeds' GT instances
    (``gather_seed_instances``), the training forward and ``gspn_loss``.
    The CVAE noise is ``z_eps (B, num_seeds, latent)``, or is drawn from
    ``generator``."""
    lw = loss_weights or {}
    if seed_method == "random":
        raise not_ported('seed_method="random" (ops/sampling.py prob_sample)', TRAINING)
    if seed_method != "fps":
        raise ValueError(f"seed_method must be fps|random, got {seed_method!r}")

    def loss_fn(model: GSPN, batch: dict, z_eps=None, generator=None):
        if not model.training:
            raise ValueError("the GSPN loss runs the training forward: call model.train()")
        cfg = model.config
        xyz, valid = batch["xyz"], batch["valid"]
        seed_idx = ops.farthest_point_sample(
            num_seeds, xyz, valid, impl=cfg.ops_impl,
            segments=ops.eligible_fps_segments(cfg.fps_segments, num_seeds, xyz.shape[1]),
            segment_mode=cfg.fps_segment_mode,
        )
        gt_points, gt_valid, gt_center, is_fg = gather_seed_instances(
            xyz, batch["inst_label"], seed_idx, gt_size
        )
        out = model(xyz, seed_idx, valid, z_eps=z_eps, generator=generator,
                    gt_points=gt_points, gt_valid=gt_valid)
        return gspn_loss(out, gt_points, gt_valid, gt_center, is_fg, impl=cfg.ops_impl, **lw)

    return loss_fn


def set_bn_momentum(model: torch.nn.Module, momentum: float) -> None:
    for mod in model.modules():
        if isinstance(mod, MaskedBatchNorm):
            mod.momentum = momentum


def make_train_step(loss_fn, lr_schedule=None, bn_momentum_fn=None):
    """``step(state, batch, z_eps=None, generator=None) -> metrics``: the
    learning rate ``lr_schedule(state.step)`` and the BatchNorm momentum
    ``bn_momentum_fn(state.step)`` (each at the count before the update, as
    optax evaluates a schedule), zero the gradients, the loss and its
    backward, one optimizer step, then ``state.step += 1``."""

    def step(state: TrainState, batch: dict, z_eps=None, generator=None) -> dict:
        if lr_schedule is not None:
            lr = lr_schedule(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
        if bn_momentum_fn is not None:
            set_bn_momentum(state.model, bn_momentum_fn(state.step))
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(state.model, batch, z_eps=z_eps, generator=generator)
        total.backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step
