"""Stage-2 trainer: R-PointNet over the proposals of a frozen GSPN, on the card.

    python -m gspn_tpu_torch.train.train_rpointnet --steps 200 --gspn-ckpt runs/gspn/ckpt
    python -m gspn_tpu_torch.train.train_rpointnet --device cpu --preset tiny --steps 20

The flags and defaults of ``gspn_tpu.train.train_rpointnet`` (synthetic
scenes, B=2 x N=4096, ``RPointNetConfig()`` at full width, 32 GT instances
a scene at most, Adam at 1e-3), plus ``--device`` (default ``cuda``;
without a CUDA device it exits with an error and never falls back to the
CPU). Without ``--gspn-ckpt`` (or with ``--gt-boxes``) the RoIs are the
scenes' GT boxes jittered; with it, the proposals of the GSPN that
``train_gspn`` saved under that directory (its latest checkpoint, the
recognition network dropped), at ``--num-seeds`` FPS seeds, followed by
the jittered GT boxes unless ``--no-mix-gt-boxes``. Batch ``i`` is a pure
function of ``(seed, i)`` and step ``i``'s draws (augmentation, GT-box
jitter, the frozen GSPN's noise, then any Gumbel and dropout noise) come
from a generator seeded by ``(seed, i)``, so ``--resume`` continues the
uninterrupted run bit for bit. Flags whose code is not ported raise
``NotImplementedError`` naming their ``ROADMAP.md`` entry.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from gspn_tpu_torch.convert import GSPN_TRAINING_ONLY
from gspn_tpu_torch.data.iterator import DeterministicBatches
from gspn_tpu_torch.data.layout_probe import warn_if_layout_biased
from gspn_tpu_torch.models.gspn import KNOB_PATHS, GSPN, GSPNConfig, not_ported
from gspn_tpu_torch.models.presets import scale_gspn_widths, scale_rpointnet_widths
from gspn_tpu_torch.models.rpointnet import RPointNet, RPointNetConfig, SALayerSpec
from gspn_tpu_torch.nn.layers import glorot_init_
from gspn_tpu_torch.train.checkpoint import latest_model_state
from gspn_tpu_torch.train.schedules import build_lr_schedule
from gspn_tpu_torch.train.steps import TrainState, make_optimizer, make_rpointnet_loss_fn
from gspn_tpu_torch.train.train_gspn import (
    DATA_LOADERS,
    PARALLEL,
    TINY_GSPN,
    add_common_args,
    make_sample_fn,
    resolve_device,
    train_loop,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train R-PointNet (stage 2)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--num-points", type=int, default=4096)
    p.add_argument("--morton", action="store_true", help="not ported")
    p.add_argument("--num-seeds", type=int, default=64)
    p.add_argument("--max-instances", type=int, default=32)
    p.add_argument("--num-classes", type=int, default=18)
    p.add_argument("--log-dir", type=str, default="runs/rpointnet")
    p.add_argument("--gspn-ckpt", type=str, default=None,
                   help="train_gspn's checkpoint directory ({log_dir}/ckpt) for frozen proposals")
    p.add_argument("--gt-boxes", action="store_true",
                   help="train with jittered GT boxes instead of GSPN proposals")
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
    p.add_argument("--partnet-dir", type=str, default=None, help="not ported")
    p.add_argument("--no-mix-gt-boxes", action="store_true",
                   help="disable GT-box mixing into stage-2 RoIs")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--preset", choices=["default", "tiny"], default="default")
    add_common_args(p)
    return p.parse_args(argv)


def check_ported(args) -> None:
    """Raise ``NotImplementedError`` for a flag whose code is not ported."""
    unported = [
        (args.dp, "--dp (data-parallel training)", PARALLEL),
        (args.point_sharded, "--point-sharded", PARALLEL),
        (args.data_rows, "--data-rows", PARALLEL),
        (args.scannet_dir, "--scannet-dir (ScanNet crops)", DATA_LOADERS),
        (args.partnet_dir, "--partnet-dir (PartNet parts)", DATA_LOADERS),
        (args.morton, "--morton (host Morton sort)", DATA_LOADERS),
        (args.dtype == "bf16", "--dtype bf16", KNOB_PATHS),
    ]
    for flagged, what, item in unported:
        if flagged:
            raise not_ported(what, item)


def tiny_rpointnet(num_classes: int) -> RPointNetConfig:
    """The ``--preset tiny`` config (the JAX trainer's)."""
    return RPointNetConfig(
        sa_layers=(
            SALayerSpec(64, 0.4, 16, (16, 32)),
            SALayerSpec(16, 0.8, 16, (32, 64)),
        ),
        fp_mlps=((32,), (32, 32)),
        roi_samples=16,
        roi_mlp=(32, 32),
        cls_fc=(32,),
        box_fc=(32,),
        mask_mlp=(32,),
        num_classes=num_classes,
    )


def _stage_knobs(cfg, args, fdim: int, scale_widths):
    """The data's feature width, ``--width-mult`` (by ``scale_widths``, the
    stage's ``presets.scale_*_widths``) and the trainer's FPS and selection
    flags on a stage config, as the JAX trainer sets them on both stages."""
    if fdim != cfg.feature_dim:
        cfg = dataclasses.replace(cfg, feature_dim=fdim)
    if args.width_mult != 1:
        cfg = scale_widths(cfg, args.width_mult)
    if args.fps_segments != 1:
        cfg = dataclasses.replace(cfg, fps_segments=args.fps_segments,
                                  fps_segment_mode=args.fps_segment_mode)
    if args.group_select != "first":
        cfg = dataclasses.replace(cfg, group_select=args.group_select)
    return cfg


def model_config(args, first: dict) -> RPointNetConfig:
    cfg = (tiny_rpointnet(args.num_classes) if args.preset == "tiny"
           else RPointNetConfig(num_classes=args.num_classes))
    fdim = int(first["features"].shape[-1]) if "features" in first else 0
    cfg = _stage_knobs(cfg, args, fdim, scale_rpointnet_widths)
    if args.group_select == "first":  # warn when the layout is in the first-K pathology regime
        sa1 = cfg.sa_layers[0]
        warn_if_layout_biased(first, radius=float(sa1.radius), k=int(sa1.nsample),
                              where="training data")
    return cfg


def load_frozen_gspn(ckpt_dir: str, cfg: GSPNConfig, device) -> GSPN:
    """An inference GSPN in eval mode on ``device`` with the weights of the
    newest ``train_gspn`` checkpoint under ``ckpt_dir`` (a ``GSPN(cfg,
    recognition=True)`` state dict: the recognition network's entries are
    dropped, as ``convert.GSPN_TRAINING_ONLY`` names them)."""
    state = latest_model_state(ckpt_dir)
    model = GSPN(cfg)
    model.load_state_dict({k: v for k, v in state.items()
                           if k.split(".")[0] not in GSPN_TRAINING_ONLY})
    return model.to(device).eval()


def main(argv=None) -> TrainState:
    args = parse_args(argv)
    check_ported(args)
    device = resolve_device(args.device, "train_rpointnet")

    batches = DeterministicBatches(make_sample_fn(args), args.batch, args.seed)
    first = batches.batch_at(0)
    cfg = model_config(args, first)
    model = RPointNet(cfg)
    glorot_init_(model, torch.Generator().manual_seed(args.seed))
    model.to(device).train()
    lr_fn = build_lr_schedule(args)
    state = TrainState(model, make_optimizer(model, lr_fn(0)))
    n_params = sum(p.numel() for p in model.parameters())
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"R-PointNet: {n_params / 1e6:.2f}M params, device={device} ({where}), "
          f"feature_dim={cfg.feature_dim}")

    frozen = None
    if args.gspn_ckpt and not args.gt_boxes:
        gcfg = _stage_knobs(TINY_GSPN if args.preset == "tiny" else GSPNConfig(), args,
                            cfg.feature_dim, scale_gspn_widths)
        frozen = (load_frozen_gspn(args.gspn_ckpt, gcfg, device), args.num_seeds)
        print(f"loaded frozen GSPN from {args.gspn_ckpt}")
    loss_fn = make_rpointnet_loss_fn(args.max_instances, frozen,
                                     mix_gt_boxes=not args.no_mix_gt_boxes)
    return train_loop(args, state, loss_fn, lr_fn, cfg, batches, device)


if __name__ == "__main__":
    main()
