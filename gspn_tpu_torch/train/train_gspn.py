"""Stage-1 trainer: the GSPN CVAE proposal network, on the card.

    python -m gspn_tpu_torch.train.train_gspn --steps 200
    python -m gspn_tpu_torch.train.train_gspn --device cpu --preset tiny --steps 20

The flags and defaults of ``gspn_tpu.train.train_gspn`` (synthetic scenes,
B=4 x N=4096, 64 FPS seeds, 256 GT points per seed, ``GSPNConfig()`` at
full width, Adam at 1e-3; ``--preset object --synthetic-objects``, the
single-object CVAE of ``shapenet_config`` on synthetic objects; ``--dtype
bf16``, bfloat16 MLP and head compute; ``--scannet-dir``, ``--shapenet-dir``
and ``--partnet-dir`` read real data, ``--morton`` sorts each scene's points
into Morton order; the data's per-point features widen the crops; ``--dp``
trains data-parallel over the ``torch.distributed`` ranks,
``parallel/mesh.py``; ``--point-sharded`` shards each scene's seeds over
them, ``--data-rows`` also its scenes over rows of ranks,
``parallel/train_points.py``), plus ``--device`` (default ``cuda``; without a
CUDA device it exits with an error and never falls back to the CPU). Batch
``i`` is a pure function of ``(seed, i)`` and step ``i``'s random draws
(augmentation, then the CVAE noise) come from a generator seeded by
``(seed, i)``, so ``--resume`` continues the uninterrupted run bit for bit,
on the CPU and on the card (``gather_point``'s backward adds in a fixed
order there too). Float32 matrix products stay float32 (torch's default,
TF32 off).

Under ``--dp`` every rank builds the same batches, augments the whole
batch and trains on its rows (``--batch`` must split evenly over the
ranks) with the DP-aware loss, so a step is the single-process step on the
whole batch; rank 0 alone writes the checkpoints, the config and the
metrics. ``--point-sharded`` does the same with the batch whole on every
rank and each scene's seeds split over the ranks (``--num-seeds`` must
split over a row); ``--data-rows R`` splits the ranks into R rows, the
scenes over the rows (``--batch`` must split over them)::

    torchrun --nproc-per-node 2 -m gspn_tpu_torch.train.train_gspn --dp --steps 200
    torchrun --nproc-per-node 4 -m gspn_tpu_torch.train.train_gspn --point-sharded \
        --data-rows 2 --steps 200
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from gspn_tpu_torch.data import native, synthetic
from gspn_tpu_torch.data.augment import augment_scene
from gspn_tpu_torch.data.iterator import DeterministicBatches, make_feed, to_device
from gspn_tpu_torch.data.layout_probe import warn_if_layout_biased
from gspn_tpu_torch.data.partnet import PartNetParts
from gspn_tpu_torch.data.scannet import ScanNetCrops
from gspn_tpu_torch.data.shapenet import ShapeNetObjects
from gspn_tpu_torch.models.gspn import GSPN, GSPNConfig, shapenet_config
from gspn_tpu_torch.models.presets import scale_gspn_widths
from gspn_tpu_torch.nn.layers import glorot_init_
from gspn_tpu_torch.parallel import (
    DataMesh,
    PointMesh,
    make_dp_train_step,
    make_mesh,
    make_mesh_2d,
    make_point_sharded_gspn_loss_fn,
    make_point_sharded_train_step,
    replicate,
    shard_batch,
)
from gspn_tpu_torch.train.checkpoint import CheckpointManager
from gspn_tpu_torch.train.config_io import save_config
from gspn_tpu_torch.train.metrics import MetricsLogger, format_metrics
from gspn_tpu_torch.train.schedules import bn_momentum_schedule, build_lr_schedule
from gspn_tpu_torch.train.steps import (
    TrainState,
    make_gspn_loss_fn,
    make_optimizer,
    make_train_step,
)
from gspn_tpu_torch.utils.profiling import StepTraceWindow

TINY_GSPN = GSPNConfig(
    context_radii=(0.3, 0.6),
    context_nsample=(16, 32),
    encoder_mlp=(16, 32),
    center_mlp=(16, 32),
    center_fc=(32,),
    latent_dim=8,
    cond_dim=32,
    generator_fc=(64,),
    num_gen_points=32,
    objectness_fc=(16,),
)


def add_common_args(p: argparse.ArgumentParser) -> None:
    """The flags both stage trainers take (``--device`` and those of the JAX
    package's ``add_common_args``)."""
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) exits when there is no CUDA device")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr-schedule", choices=["constant", "exp", "cosine"], default="constant",
                   help="'exp' = the reference's staircase exponential decay")
    p.add_argument("--lr-decay-steps", type=int, default=10000)
    p.add_argument("--lr-decay-rate", type=float, default=0.7)
    p.add_argument("--lr-min", type=float, default=1e-5)
    p.add_argument("--bn-decay", action="store_true",
                   help="schedule BN momentum toward 0.99 (reference get_bn_decay idiom)")
    p.add_argument("--bn-decay-steps", type=int, default=10000)
    p.add_argument("--bn-decay-rate", type=float, default=0.5)
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint under --log-dir and continue the run")
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                   help="MLP and head compute dtype (parameters stay float32)")
    p.add_argument("--width-mult", type=int, default=1,
                   help="multiply every MLP/FC width (sampling geometry unchanged; "
                        "models/presets.py scale_*_widths); stage 2, export and eval must "
                        "pass the value the checkpoint was trained with")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="torch.profiler trace of this many steps (after one warm-up step) "
                        "under {log_dir}/trace, with a JSON line of wall and device ms per "
                        "step and the device's idle share")
    p.add_argument("--fps-segments", type=int, default=1,
                   help=">1: segmented parallel-chain FPS approximation where eligible")
    p.add_argument("--fps-segment-mode", choices=["contiguous", "strided", "spatial"],
                   default="spatial")
    p.add_argument("--group-select", choices=["first", "strided"], default="first",
                   help="context-crop K-selection (must match between training and eval)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train GSPN (stage 1)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--num-points", type=int, default=4096)
    p.add_argument("--morton", action="store_true",
                   help="Morton-sort each scene's points (a spatially coherent order the "
                        "group kernels' AABB tiles prune on)")
    p.add_argument("--num-seeds", type=int, default=64)
    p.add_argument("--gt-size", type=int, default=256)
    p.add_argument("--kl-weight", type=float, default=1.0)
    p.add_argument("--log-dir", type=str, default="runs/gspn")
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--eval-every", type=int, default=0,
                   help="validation-loss interval on a held-out batch (0 = off)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dp", action="store_true",
                   help="data-parallel over the torch.distributed ranks (torchrun)")
    p.add_argument("--point-sharded", action="store_true",
                   help="shard each scene's seeds over the torch.distributed ranks, the batch "
                        "whole on every rank (parallel/train_points.py)")
    p.add_argument("--data-rows", type=int, default=0,
                   help="with --point-sharded: a 2-D mesh, the scenes split over this many "
                        "rows of ranks and each scene's work over the ranks of a row")
    p.add_argument("--prefetch", type=int, default=2,
                   help="stage this many batches on the card ahead of the running step "
                        "(0 disables); the same batches in the same order")
    p.add_argument("--synthetic", action="store_true", default=True)
    p.add_argument("--scannet-dir", type=str, default=None,
                   help="preprocessed ScanNet scenes (data.preprocess_scannet's .npz)")
    p.add_argument("--shapenet-dir", type=str, default=None,
                   help="ShapeNet h5 dir: single-object CVAE pretraining")
    p.add_argument("--shapenet-category", type=int, default=None)
    p.add_argument("--partnet-dir", type=str, default=None, help="PartNet ins_seg h5 dir")
    p.add_argument("--synthetic-objects", action="store_true",
                   help="single synthetic objects, one instance each (BASELINE config 1)")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--preset", choices=["default", "tiny", "object"], default="default",
                   help="tiny = small config for smoke tests / CPU; object = the "
                        "single-object CVAE (one crop of radius 2 holding every point)")
    add_common_args(p)
    return p.parse_args(argv)


def check_flags(args) -> None:
    """The JAX trainers' refusal of ``--dp`` with ``--point-sharded``, and
    of ``--data-rows`` without ``--point-sharded`` (which the JAX trainers
    ignore)."""
    if args.dp and args.point_sharded:
        raise SystemExit("--dp and --point-sharded are mutually exclusive")
    if args.data_rows and not args.point_sharded:
        raise SystemExit("--data-rows requires --point-sharded")


def resolve_device(name: str, prog: str = "train_gspn") -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: --device cuda needs a CUDA device and "
                         "torch.cuda.is_available() is false; pass --device cpu to run "
                         "on the CPU")
    return device


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """Step ``step``'s generator, seeded from ``(seed, step)`` alone."""
    state = np.random.SeedSequence(entropy=seed, spawn_key=(step, 1)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def make_sample_fn(args, impl: str = "auto"):
    """``sample_fn(np_rng, batch_size) -> batch dict`` for the data source,
    as the JAX trainer's: ScanNet crops (``--scannet-dir``, Morton-sorted
    inside the crop with ``--morton``), ShapeNet objects (``--shapenet-dir``,
    ``--shapenet-category``), PartNet parts (``--partnet-dir``), synthetic
    single objects (``--synthetic-objects``) or synthetic scenes; with
    ``--morton`` every source but ScanNet is sorted by
    ``native.morton_sort_batch``. ``impl``: the point-prep route
    (``data/native.py``; a ScanNet crop's subsample depends on it)."""
    if getattr(args, "scannet_dir", None):
        ds = ScanNetCrops(args.scannet_dir, num_points=args.num_points,
                          morton=getattr(args, "morton", False), impl=impl)
        return ds.sample_batch
    if getattr(args, "shapenet_dir", None):
        ds = ShapeNetObjects(args.shapenet_dir, num_points=args.num_points,
                             category=getattr(args, "shapenet_category", None))
        return _maybe_morton(args, ds.sample_batch, impl)
    if getattr(args, "partnet_dir", None):
        ds = PartNetParts(args.partnet_dir, num_points=args.num_points)
        return _maybe_morton(args, ds.sample_batch, impl)
    if getattr(args, "synthetic_objects", False):
        return _maybe_morton(args, lambda rng, b: synthetic.object_scene_batch(
            rng, b, n_points=args.num_points), impl)
    return _maybe_morton(args, lambda rng, b: synthetic.scene_batch(
        rng, b, n_points=args.num_points, max_instances=8), impl)


def _maybe_morton(args, sample_fn, impl: str):
    """``sample_fn`` followed by the host Morton sort under ``--morton``."""
    if not getattr(args, "morton", False):
        return sample_fn
    return lambda rng, b: native.morton_sort_batch(sample_fn(rng, b), impl=impl)


def batch_feature_dim(batch: dict) -> int:
    """The per-point feature width of a batch (0 without features)."""
    f = batch.get("features")
    return 0 if f is None else int(f.shape[-1])


def model_config(args, first: dict) -> GSPNConfig:
    if args.preset == "object":
        cfg = shapenet_config(args.num_points, num_gen_points=512)
    else:
        cfg = TINY_GSPN if args.preset == "tiny" else GSPNConfig()
    fdim = batch_feature_dim(first)
    if fdim != cfg.feature_dim:  # consume RGB & friends when the data has them
        cfg = dataclasses.replace(cfg, feature_dim=fdim)
    if args.width_mult != 1:
        cfg = scale_gspn_widths(cfg, args.width_mult)
    if args.dtype == "bf16":
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    if args.fps_segments != 1:
        cfg = dataclasses.replace(cfg, fps_segments=args.fps_segments,
                                  fps_segment_mode=args.fps_segment_mode)
    if args.group_select != "first":
        cfg = dataclasses.replace(cfg, group_select=args.group_select)
    else:  # warn when the layout is in the measured first-K pathology regime
        mid = min(1, len(cfg.context_radii) - 1)
        warn_if_layout_biased(first, radius=float(cfg.context_radii[mid]),
                              k=int(cfg.context_nsample[mid]), where="training data")
    return cfg


def validation_metrics(model, loss_fn, batch, generator) -> dict:
    """The loss on a held-out batch in the training forward (BatchNorm on
    the batch's own statistics, as the JAX package's validation loss), with
    the running statistics left as they were."""
    saved = [b.clone() for b in model.buffers()]
    with torch.no_grad():
        _, metrics = loss_fn(model, batch, generator=generator)
        for b, old in zip(model.buffers(), saved, strict=True):
            b.copy_(old)
    return {f"val_{k}": float(v) for k, v in metrics.items()}


def open_mesh(args, device) -> DataMesh | PointMesh | None:
    """``--dp``'s :class:`DataMesh`, ``--point-sharded``'s :class:`PointMesh`
    (``--data-rows`` rows, else one), or None; ``--batch`` must split evenly
    over the DP ranks or the rows."""
    if args.point_sharded:
        mesh = make_mesh_2d(args.data_rows or 1, device=device)
        if args.batch % mesh.n_data:
            mesh.close()
            raise SystemExit(f"--batch {args.batch} must be divisible by --data-rows "
                             f"{args.data_rows}")
        return mesh
    if not args.dp:
        return None
    mesh = make_mesh(device)
    if args.batch % mesh.size:
        mesh.close()
        raise SystemExit(f"--batch {args.batch} must be divisible by the {mesh.size} ranks "
                         "of --dp")
    return mesh


def mesh_note(mesh) -> str:
    """How the run is split, for the trainers' first line."""
    if isinstance(mesh, PointMesh):
        return f", --point-sharded over {mesh.n_data} x {mesh.n_space} ranks"
    return f", --dp over {mesh.size} ranks" if mesh is not None else ""


def dp_loss_kwargs(mesh: DataMesh | None) -> dict:
    """The loss factories' DP arguments for ``mesh`` (none without one)."""
    return {} if mesh is None else {"dp_group": mesh.group, "dp_size": mesh.size}


def main(argv=None) -> TrainState:
    args = parse_args(argv)
    check_flags(args)
    device = resolve_device(args.device)
    mesh = open_mesh(args, device)
    try:
        if mesh is not None:
            device = mesh.device
        batches = DeterministicBatches(make_sample_fn(args), args.batch, args.seed)
        cfg = model_config(args, batches.batch_at(0))
        model = GSPN(cfg, recognition=True)
        glorot_init_(model, torch.Generator().manual_seed(args.seed))
        model.to(device).train()
        if mesh is not None:
            replicate(mesh, model)
        lr_fn = build_lr_schedule(args)
        state = TrainState(model, make_optimizer(model, lr_fn(0)))
        n_params = sum(p.numel() for p in model.parameters())
        where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        if mesh is None or mesh.rank == 0:
            print(f"GSPN: {n_params / 1e6:.2f}M params, device={device} ({where}), "
                  f"feature_dim={cfg.feature_dim}" + mesh_note(mesh))

        weights = {"kl_weight": args.kl_weight}
        if isinstance(mesh, PointMesh):
            loss_fn = make_point_sharded_gspn_loss_fn(cfg, mesh, args.num_seeds, args.gt_size,
                                                      weights)
        else:
            loss_fn = make_gspn_loss_fn(args.num_seeds, args.gt_size, weights,
                                        **dp_loss_kwargs(mesh))
        return train_loop(args, state, loss_fn, lr_fn, cfg, batches, device, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def train_loop(args, state: TrainState, loss_fn, lr_fn, cfg, batches: DeterministicBatches,
               device, mesh: DataMesh | PointMesh | None = None) -> TrainState:
    """Both trainers' loop: ``--resume`` from ``{log_dir}/ckpt``, the config
    beside it, then steps ``start..args.steps-1`` (step ``i``: batch ``i``
    augmented, unless ``--no-augment``, and ``loss_fn``'s draws, both from
    ``step_generator(seed, i)``), metrics JSONL every ``--log-every``, the
    validation loss on a held-out batch every ``--eval-every``, a checkpoint
    every ``--ckpt-every`` and at the end, a profiler window of
    ``--profile-steps``. With a ``mesh`` each rank steps on its rows of the
    augmented batch with ``parallel.make_dp_train_step`` (``--dp``) or on
    the whole batch with ``parallel.make_point_sharded_train_step``
    (``--point-sharded``), and rank 0 alone writes (the others wait for
    each checkpoint)."""
    bn_fn = (bn_momentum_schedule(decay_steps=args.bn_decay_steps,
                                  decay_rate=args.bn_decay_rate) if args.bn_decay else None)
    if mesh is None:
        step_fn = make_train_step(loss_fn, lr_fn, bn_fn)
    elif isinstance(mesh, PointMesh):
        step_fn = make_point_sharded_train_step(loss_fn, mesh, lr_fn, bn_fn)
    else:
        step_fn = make_dp_train_step(loss_fn, mesh, lr_fn, bn_fn)
    writer = mesh is None or mesh.rank == 0

    def rows(batch):
        return shard_batch(mesh, batch) if isinstance(mesh, DataMesh) else batch

    ckpt = CheckpointManager(f"{args.log_dir}/ckpt")
    if args.resume:
        if ckpt.restore(state):
            print(f"--resume: restored step {state.step}")
        else:
            print("--resume: no checkpoint found, starting fresh")
    start_step = state.step
    logger = MetricsLogger(args.log_dir) if writer else None
    if writer:
        save_config(f"{args.log_dir}/config.json", model=cfg, args=args)

    val_batch = None
    if args.eval_every:  # a held-out batch from a disjoint stream
        val_batch = rows(to_device(DeterministicBatches(
            make_sample_fn(args), args.batch, args.seed + 1_000_003).batch_at(0), device))

    tracer = StepTraceWindow(f"{args.log_dir}/trace", start_step + 1,
                             args.profile_steps if writer else 0, device)
    try:
        for i, batch in make_feed(batches, start_step, args.steps, args.prefetch, device):
            tracer.tick(i)
            gen = step_generator(args.seed, i, device)
            if not args.no_augment:
                batch = dict(batch, xyz=augment_scene(batch["xyz"], batch["valid"], generator=gen))
            metrics = step_fn(state, rows(batch), generator=gen)
            if writer and ((i + 1) % args.log_every == 0 or i == start_step):
                m = {k: float(v) for k, v in metrics.items()}
                logger.log(state.step, m)
                print(format_metrics(state.step, m))
            if args.eval_every and (i + 1) % args.eval_every == 0:
                vm = validation_metrics(state.model, loss_fn, val_batch,
                                        step_generator(args.seed + 1, 0, device))
                if writer:
                    logger.log(state.step, vm)
                    print(format_metrics(state.step, vm))
            if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
                if writer:
                    ckpt.save(state)
                if mesh is not None:
                    dist.barrier()
    finally:
        tracer.close()
        if logger is not None:
            logger.close()
    return state


if __name__ == "__main__":
    main()
