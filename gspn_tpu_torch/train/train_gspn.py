"""Stage-1 trainer: the GSPN CVAE proposal network, on the card.

    python -m gspn_tpu_torch.train.train_gspn --steps 200
    python -m gspn_tpu_torch.train.train_gspn --device cpu --preset tiny --steps 20

The flags and defaults of ``gspn_tpu.train.train_gspn`` (synthetic scenes,
B=4 x N=4096, 64 FPS seeds, 256 GT points per seed, ``GSPNConfig()`` at
full width, Adam at 1e-3), plus ``--device`` (default ``cuda``; without a
CUDA device it exits with an error and never falls back to the CPU). Batch
``i`` is a pure function of ``(seed, i)`` and step ``i``'s random draws
(augmentation, then the CVAE noise) come from a generator seeded by
``(seed, i)``, so ``--resume`` continues the uninterrupted run bit for bit,
on the CPU and on the card (``gather_point``'s backward adds in a fixed
order there too). Float32 matrix products stay float32 (torch's default,
TF32 off). Flags whose code is not
ported raise ``NotImplementedError`` naming their ``ROADMAP.md`` entry.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from gspn_tpu_torch.data import synthetic
from gspn_tpu_torch.data.augment import augment_scene
from gspn_tpu_torch.data.iterator import DeterministicBatches, make_feed, to_device
from gspn_tpu_torch.data.layout_probe import warn_if_layout_biased
from gspn_tpu_torch.models.gspn import KNOB_PATHS, GSPN, GSPNConfig, not_ported
from gspn_tpu_torch.models.presets import scale_gspn_widths
from gspn_tpu_torch.nn.layers import glorot_init_
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

PARALLEL = "Parallel"  # ROADMAP.md entries of the flags not ported yet
DATA_LOADERS = "Data loaders"

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
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32", help="bf16 is not ported")
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
    p.add_argument("--morton", action="store_true", help="not ported")
    p.add_argument("--num-seeds", type=int, default=64)
    p.add_argument("--gt-size", type=int, default=256)
    p.add_argument("--kl-weight", type=float, default=1.0)
    p.add_argument("--log-dir", type=str, default="runs/gspn")
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--eval-every", type=int, default=0,
                   help="validation-loss interval on a held-out batch (0 = off)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dp", action="store_true", help="not ported")
    p.add_argument("--point-sharded", action="store_true", help="not ported")
    p.add_argument("--data-rows", type=int, default=0, help="not ported")
    p.add_argument("--prefetch", type=int, default=2,
                   help="stage this many batches on the card ahead of the running step "
                        "(0 disables); the same batches in the same order")
    p.add_argument("--synthetic", action="store_true", default=True)
    p.add_argument("--scannet-dir", type=str, default=None, help="not ported")
    p.add_argument("--shapenet-dir", type=str, default=None, help="not ported")
    p.add_argument("--shapenet-category", type=int, default=None)
    p.add_argument("--partnet-dir", type=str, default=None, help="not ported")
    p.add_argument("--synthetic-objects", action="store_true", help="not ported")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--preset", choices=["default", "tiny", "object"], default="default",
                   help="tiny = small config for smoke tests / CPU; object is not ported")
    add_common_args(p)
    return p.parse_args(argv)


def check_ported(args) -> None:
    """Raise ``NotImplementedError`` for a flag whose code is not ported."""
    unported = [
        (args.dp, "--dp (data-parallel training)", PARALLEL),
        (args.point_sharded, "--point-sharded", PARALLEL),
        (args.data_rows, "--data-rows", PARALLEL),
        (args.scannet_dir, "--scannet-dir (ScanNet crops)", DATA_LOADERS),
        (args.shapenet_dir, "--shapenet-dir (ShapeNet objects)", DATA_LOADERS),
        (args.partnet_dir, "--partnet-dir (PartNet parts)", DATA_LOADERS),
        (args.synthetic_objects, "--synthetic-objects", DATA_LOADERS),
        (args.preset == "object", "--preset object", DATA_LOADERS),
        (args.morton, "--morton (host Morton sort)", DATA_LOADERS),
        (args.dtype == "bf16", "--dtype bf16", KNOB_PATHS),
    ]
    for flagged, what, item in unported:
        if flagged:
            raise not_ported(what, item)


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


def make_sample_fn(args):
    return lambda rng, b: synthetic.scene_batch(rng, b, n_points=args.num_points,
                                                max_instances=8)


def model_config(args, first: dict) -> GSPNConfig:
    cfg = TINY_GSPN if args.preset == "tiny" else GSPNConfig()
    fdim = int(first["features"].shape[-1]) if "features" in first else 0
    if fdim != cfg.feature_dim:  # consume RGB & friends when the data has them
        cfg = dataclasses.replace(cfg, feature_dim=fdim)
    if args.width_mult != 1:
        cfg = scale_gspn_widths(cfg, args.width_mult)
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


def main(argv=None) -> TrainState:
    args = parse_args(argv)
    check_ported(args)
    device = resolve_device(args.device)

    batches = DeterministicBatches(make_sample_fn(args), args.batch, args.seed)
    cfg = model_config(args, batches.batch_at(0))
    model = GSPN(cfg, recognition=True)
    glorot_init_(model, torch.Generator().manual_seed(args.seed))
    model.to(device).train()
    lr_fn = build_lr_schedule(args)
    state = TrainState(model, make_optimizer(model, lr_fn(0)))
    n_params = sum(p.numel() for p in model.parameters())
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"GSPN: {n_params / 1e6:.2f}M params, device={device} ({where}), "
          f"feature_dim={cfg.feature_dim}")

    loss_fn = make_gspn_loss_fn(args.num_seeds, args.gt_size, {"kl_weight": args.kl_weight})
    return train_loop(args, state, loss_fn, lr_fn, cfg, batches, device)


def train_loop(args, state: TrainState, loss_fn, lr_fn, cfg, batches: DeterministicBatches,
               device) -> TrainState:
    """Both trainers' loop: ``--resume`` from ``{log_dir}/ckpt``, the config
    beside it, then steps ``start..args.steps-1`` (step ``i``: batch ``i``
    augmented, unless ``--no-augment``, and ``loss_fn``'s draws, both from
    ``step_generator(seed, i)``), metrics JSONL every ``--log-every``, the
    validation loss on a held-out batch every ``--eval-every``, a checkpoint
    every ``--ckpt-every`` and at the end, a profiler window of
    ``--profile-steps``."""
    bn_fn = (bn_momentum_schedule(decay_steps=args.bn_decay_steps,
                                  decay_rate=args.bn_decay_rate) if args.bn_decay else None)
    step_fn = make_train_step(loss_fn, lr_fn, bn_fn)

    ckpt = CheckpointManager(f"{args.log_dir}/ckpt")
    if args.resume:
        if ckpt.restore(state):
            print(f"--resume: restored step {state.step}")
        else:
            print("--resume: no checkpoint found, starting fresh")
    start_step = state.step
    logger = MetricsLogger(args.log_dir)
    save_config(f"{args.log_dir}/config.json", model=cfg, args=args)

    val_batch = None
    if args.eval_every:  # a held-out batch from a disjoint stream
        val_batch = to_device(DeterministicBatches(
            make_sample_fn(args), args.batch, args.seed + 1_000_003).batch_at(0), device)

    tracer = StepTraceWindow(f"{args.log_dir}/trace", start_step + 1, args.profile_steps, device)
    try:
        for i, batch in make_feed(batches, start_step, args.steps, args.prefetch, device):
            tracer.tick(i)
            gen = step_generator(args.seed, i, device)
            if not args.no_augment:
                batch = dict(batch, xyz=augment_scene(batch["xyz"], batch["valid"], generator=gen))
            metrics = step_fn(state, batch, generator=gen)
            if (i + 1) % args.log_every == 0 or i == start_step:
                m = {k: float(v) for k, v in metrics.items()}
                logger.log(state.step, m)
                print(format_metrics(state.step, m))
            if args.eval_every and (i + 1) % args.eval_every == 0:
                vm = validation_metrics(state.model, loss_fn, val_batch,
                                        step_generator(args.seed + 1, 0, device))
                logger.log(state.step, vm)
                print(format_metrics(state.step, vm))
            if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
                ckpt.save(state)
    finally:
        tracer.close()
        logger.close()
    return state


if __name__ == "__main__":
    main()
