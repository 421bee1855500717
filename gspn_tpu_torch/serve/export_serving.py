"""Export a two-stage pipeline to a serving artifact.

The port's counterpart of ``scripts/export_serving.py``, with the same
flags plus ``--device`` (default ``cuda``; the artifact runs on the
device it was traced on). It builds the pipeline config, restores the
stage checkpoints of ``train_gspn`` and ``train_rpointnet`` over seeded
weights, traces the program at the serving shape and writes the artifact
(``serve/export.py``)::

    python -m gspn_tpu_torch.serve.export_serving --out model.gspnt \\
        --gspn-ckpt runs/s1/ckpt --rpointnet-ckpt runs/s2/ckpt \\
        --batch 8 --num-points 8192 --verify
    python -m gspn_tpu_torch.serve.export_serving --device cpu --preset tiny \\
        --out tiny.gspnt --batch 2 --num-points 256 --num-seeds 8 --verify

``--verify`` runs the artifact against the live pipeline on seeded scenes
and requires every output bit for bit before the artifact is put in place.
``--width-mult`` and ``--feature-dim`` must be the values the checkpoints
were trained with (a run's ``config.json`` beside its ``ckpt/`` is
checked); ``--feature-dim`` makes the per-point features an input of the
program, and ``--dtype bf16`` bakes bfloat16 MLP and head compute in. The
manifest's ``pipeline_config`` carries both. ``--platform``
(cross-exporting) is not ported and raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
import pathlib

import numpy as np
import torch

CROSS_PLATFORM = "Cross-platform export"  # the ROADMAP.md entry of --platform


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="export a serving artifact")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--gspn-ckpt", type=str, default=None)
    p.add_argument("--rpointnet-ckpt", type=str, default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--num-points", type=int, default=8192)
    p.add_argument("--num-seeds", type=int, default=64)
    p.add_argument("--num-classes", type=int, default=18)
    p.add_argument("--feature-dim", type=int, default=0,
                   help="per-point input features (e.g. 3 for RGB) the artifact takes")
    p.add_argument("--preset", choices=["default", "tiny"], default="default")
    p.add_argument("--width-mult", type=int, default=1,
                   help="MLP width multiplier: the checkpoints' training value")
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32")
    p.add_argument("--fps-segments", type=int, default=None,
                   help="segmented parallel-chain FPS baked into the artifact (default: the "
                        "preset's); 1 bakes the exact greedy FPS")
    p.add_argument("--fps-segment-mode", choices=["contiguous", "strided", "spatial"],
                   default="spatial")
    p.add_argument("--score-thresh", type=float, default=0.05)
    p.add_argument("--platform", type=str, default=None, help="not ported")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: where the program is traced and runs")
    p.add_argument("--verify", action="store_true",
                   help="check the artifact against the live pipeline before writing it")
    return p.parse_args(argv)


def build_config(args):
    from gspn_tpu_torch.eval.run_eval import with_feature_dim
    from gspn_tpu_torch.models.gspn import GSPNConfig, not_ported
    from gspn_tpu_torch.models.pipeline import PipelineConfig
    from gspn_tpu_torch.models.presets import (
        scale_pipeline_widths, set_pipeline_dtype, set_pipeline_fps_segments,
    )
    from gspn_tpu_torch.models.rpointnet import RPointNetConfig

    if args.platform is not None:
        raise not_ported("--platform", CROSS_PLATFORM)
    if args.preset == "tiny":
        from gspn_tpu_torch.train.train_gspn import TINY_GSPN
        from gspn_tpu_torch.train.train_rpointnet import tiny_rpointnet

        gspn, rpointnet = TINY_GSPN, tiny_rpointnet(args.num_classes)
    else:
        gspn, rpointnet = GSPNConfig(), RPointNetConfig(num_classes=args.num_classes)
    cfg = PipelineConfig(gspn=gspn, rpointnet=rpointnet, num_seeds=args.num_seeds,
                         score_thresh=args.score_thresh)
    cfg = with_feature_dim(cfg, args.feature_dim)
    if args.width_mult != 1:
        cfg = scale_pipeline_widths(cfg, args.width_mult)
    if args.dtype == "bf16":
        cfg = set_pipeline_dtype(cfg, torch.bfloat16)
    if args.fps_segments is not None:
        cfg = set_pipeline_fps_segments(cfg, args.fps_segments, args.fps_segment_mode)
    return cfg


def verify(cfg, model, program, args, device) -> None:
    """The artifact's outputs against the live pipeline's on seeded scenes,
    bit for bit."""
    from gspn_tpu_torch.models.pipeline import PREDICTION_FIELDS, make_inference_fn
    from gspn_tpu_torch.serve.export import serving_state
    from gspn_tpu_torch.serve.runtime import chunk_noise

    rng = np.random.default_rng(0)
    xyz = torch.from_numpy(rng.standard_normal((args.batch, args.num_points, 3))
                           .astype(np.float32)).to(device)
    valid = torch.ones((args.batch, args.num_points), dtype=torch.bool, device=device)
    z_eps = chunk_noise(1, 0, (args.batch, cfg.num_seeds, cfg.gspn.latent_dim)).to(device)
    feats = None
    if args.feature_dim:
        feats = torch.from_numpy(rng.standard_normal(
            (args.batch, args.num_points, args.feature_dim)).astype(np.float32)).to(device)
    with torch.inference_mode():
        live = make_inference_fn(cfg)(model, xyz, valid, z_eps=z_eps, features=feats)
        inputs = (xyz, valid, z_eps) if feats is None else (xyz, feats, valid, z_eps)
        got = program.module()(serving_state(model), *inputs)
    for f, g in zip(PREDICTION_FIELDS, got, strict=True):
        if not torch.equal(g, getattr(live, f)):
            raise AssertionError(f"verify: the artifact's {f} differs from the live pipeline's")
    print("verify: artifact == live pipeline (bit-identical)")


def main(argv=None) -> pathlib.Path:
    args = parse_args(argv)
    from gspn_tpu_torch.eval.run_eval import check_checkpoint_config
    from gspn_tpu_torch.models.pipeline import PipelineModel, init_pipeline_variables
    from gspn_tpu_torch.serve.export import export_inference, load_artifact, save_artifact
    from gspn_tpu_torch.serve.runtime import float32_matmuls, restore_checkpoints
    from gspn_tpu_torch.train.train_gspn import resolve_device

    cfg = build_config(args)
    device = resolve_device(args.device, "export_serving")
    state = init_pipeline_variables(cfg, torch.Generator().manual_seed(0), args.num_points)
    for name, ckpt in (("gspn", args.gspn_ckpt), ("rpointnet", args.rpointnet_ckpt)):
        if ckpt:
            check_checkpoint_config(ckpt, name, args.feature_dim, getattr(cfg, name))
    restore_checkpoints(state, args.gspn_ckpt, args.rpointnet_ckpt)
    for name, ckpt in (("gspn", args.gspn_ckpt), ("rpointnet", args.rpointnet_ckpt)):
        if ckpt:
            print(f"restored {name} from {ckpt}")
    model = PipelineModel(cfg)
    model.load_state_dict(state)
    model = model.to(device).eval()

    with float32_matmuls():
        program = export_inference(cfg, model, args.num_points, batch_size=args.batch,
                                   device=device)
        out = pathlib.Path(args.out)
        tmp = out.with_name(out.name + ".tmp")
        save_artifact(tmp, program, cfg, extra_meta={"gspn_ckpt": args.gspn_ckpt,
                                                     "rpointnet_ckpt": args.rpointnet_ckpt})
        if args.verify:
            verify(cfg, model, load_artifact(tmp, device)[0], args, device)
    os.replace(tmp, out)
    print(f"wrote {out} ({out.stat().st_size / 1e6:.2f} MB) platforms={[device.type]}")
    return out


if __name__ == "__main__":
    main()
