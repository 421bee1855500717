"""Data-parallel training and inference over a :class:`DataMesh`: the
PyTorch counterpart of ``gspn_tpu/parallel/dp.py``.

The DP step computes the single-process step on the whole batch, up to
the order of float sums, not a mean of per-rank normalized steps: the
DP-aware loss (``train.steps`` factories built with ``dp_group=`` /
``dp_size=``) sums its normalizers and its BatchNorm training statistics
over the ranks and draws its noise at the full batch's shape, sliced per
rank. Every rank then holds the same global loss, and since
``nn.layers.all_reduce_sum`` sends each rank the sum of the ranks' output
gradients, each rank's gradient is ``size`` times its share of the global
gradient; their mean (one all-reduce, then a division by ``size``) is the
global gradient, the argument of the JAX package's ``pmean`` of partials.
The updated parameters, the running statistics and the metrics are then
the same on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from gspn_tpu_torch.models.pipeline import InstancePredictions, PREDICTION_FIELDS
from gspn_tpu_torch.parallel.mesh import DataMesh, shard_batch
from gspn_tpu_torch.train.steps import make_train_step


def make_dp_train_step(loss_fn, mesh: DataMesh, lr_schedule=None, bn_momentum_fn=None):
    """``step(state, batch, **draws) -> metrics`` on this rank's shard of
    the batch (``shard_batch``), as ``train.steps.make_train_step`` (the
    learning-rate and BatchNorm-momentum schedules included), with the
    gradients averaged over the mesh's ranks before the optimizer step.

    ``loss_fn`` must be DP-aware for the mesh: built with
    ``dp_group=mesh.group`` and ``dp_size=mesh.size``."""
    if getattr(loss_fn, "dp_group", None) is not mesh.group:
        raise ValueError(
            "make_dp_train_step requires a DP-aware loss_fn computing the global loss over "
            "the mesh's process group: build it with make_gspn_loss_fn/"
            "make_rpointnet_loss_fn(..., dp_group=mesh.group, dp_size=mesh.size). A custom "
            "loss_fn that already sums its normalizers and BatchNorm statistics over the "
            "group can opt in with `loss_fn.dp_group = mesh.group; loss_fn.dp_size = "
            "mesh.size`.")
    loss_size = getattr(loss_fn, "dp_size", None)
    if loss_size != mesh.size:
        # silently wrong, not a shape error: the full-batch draws would be
        # sliced for another number of ranks
        raise ValueError(
            f"loss_fn was built with dp_size={loss_size} but the mesh has {mesh.size} ranks; "
            f"full-batch-shaped draws would be mis-sliced. Rebuild the loss with "
            f"dp_size={mesh.size}.")

    return make_train_step(loss_fn, lr_schedule, bn_momentum_fn,
                           combine_grads=mean_gradients(mesh.group, mesh.size))


def mean_gradients(group, size: int):
    """``combine(model)``: every parameter's gradient replaced by its mean
    over the ``size`` ranks of ``group`` (one all-reduce of the gradients
    laid end to end, then a division)."""

    def combine(model: torch.nn.Module) -> None:
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat = flat / size
        for g, part in zip(grads, flat.split([g.numel() for g in grads]), strict=True):
            g.copy_(part.view_as(g))

    return combine


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """Rank ``rank``'s noise generator for ``seed`` (JAX's
    ``fold_in(key, axis_index)``)."""
    state = np.random.SeedSequence(entropy=seed, spawn_key=(rank,)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def make_dp_inference(infer_fn, mesh: DataMesh):
    """``infer(model, xyz, valid, seed, features=None) -> InstancePredictions``
    over the mesh: each rank runs ``infer_fn`` (``models.pipeline.
    make_inference_fn``'s) on its rows of the batch with the noise of
    ``rank_generator(seed, rank)``, and the ranks' predictions are gathered
    back into the whole batch's, in rank order, on every rank."""

    def infer(model, xyz, valid, seed: int, features=None):
        rows = {"xyz": xyz, "valid": valid}
        if features is not None:
            rows["features"] = features
        local = shard_batch(mesh, rows)
        out = infer_fn(model, local["xyz"], local["valid"],
                       generator=rank_generator(seed, mesh.rank, local["xyz"].device),
                       features=local.get("features"))
        gathered = {}
        for name in PREDICTION_FIELDS:
            t = getattr(out, name)
            send = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
            parts = [torch.empty_like(send) for _ in range(mesh.size)]
            dist.all_gather(parts, send, group=mesh.group)
            whole = torch.cat(parts)
            gathered[name] = whole.bool() if t.dtype == torch.bool else whole
        return InstancePredictions(**gathered)

    return infer
