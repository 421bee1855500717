"""The roofline of a request or a training step: each stage's floor under
``utils/roofline.py``'s model (ms on each roof of the card, the floor and
the roof that binds), and with ``--measure`` the call timed on the card
against them. The counterpart of ``scripts/profile_roofline.py`` and of
the roofline half of ``scripts/bench_train.py``.

    python -m gspn_tpu_torch.utils.profile_roofline [--stage infer|1|2]
        [--preset scannet|exact|object] [--batch B] [--num-points N]
        [--width-mult M] [--dtype f32|bf16] [--measure [--way eager|session]]

The floors are arithmetic over the config and shapes and print anywhere.
``--measure`` builds the model with seeded weights on the card, times
``--requests`` calls (a request of ``make_inference_fn``, eagerly or
replayed by an ``InferenceSession``; or a training step at the trainers'
defaults) with ``utils.timing.time_fn``, each after a warm-up and
synchronized, and prints one JSON line: median, min and max ms, the
floor, ``frac_of_roof`` and ``mfu`` against ``H100_SXM`` (float32) or
``H100_SXM_BF16`` (bf16), with the card's name and power limit. It needs a
CUDA device and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import tempfile

import numpy as np
import torch

from gspn_tpu_torch.utils import roofline as rf
from gspn_tpu_torch.utils.timing import sync, time_fn

STAGES = ("infer", "1", "2")
PRESETS = ("scannet", "exact", "object")
OBJECT_GEN_POINTS = 512  # train_gspn --preset object's generated points
NUM_SEEDS = 64  # scannet_pipeline's and the trainers' seeds


def pipeline_config(stage: str = "infer", preset: str = "scannet", num_points: int = 8192,
                    width_mult: int = 1, dtype: str = "f32"):
    """The config each stage runs: a request of ``scannet_pipeline()``
    ("scannet") or of its exact FPS (``fps_segments=1``, "exact"); stage 1
    at ``train_gspn``'s defaults (``GSPNConfig()``; "object":
    ``shapenet_config(num_points, 512)``, ``--preset object``); stage 2 at
    ``bench_slice.stage2_configs()``'s. The R-PointNet of stage 1's config
    is ``RPointNetConfig()``, as ``scripts/bench_train.py`` costs it; then
    ``width_mult`` and ``dtype`` as the trainers' ``--width-mult`` and
    ``--dtype`` set them. Each has the flagship's 64 seeds."""
    from gspn_tpu_torch.models.gspn import GSPNConfig, shapenet_config
    from gspn_tpu_torch.models.pipeline import PipelineConfig
    from gspn_tpu_torch.models.presets import (
        scale_pipeline_widths, scannet_pipeline, set_pipeline_dtype,
    )
    from gspn_tpu_torch.models.rpointnet import RPointNetConfig

    if stage not in STAGES or preset not in PRESETS:
        raise ValueError(f"stage must be {'|'.join(STAGES)} and preset {'|'.join(PRESETS)}, "
                         f"got {stage!r}, {preset!r}")
    if preset == "object":
        gspn = shapenet_config(num_points, num_gen_points=OBJECT_GEN_POINTS)
        cfg = PipelineConfig(gspn=gspn, rpointnet=RPointNetConfig(), num_seeds=NUM_SEEDS)
    elif stage == "1":
        cfg = PipelineConfig(gspn=GSPNConfig(), rpointnet=RPointNetConfig(), num_seeds=NUM_SEEDS)
    else:
        cfg = scannet_pipeline(num_seeds=NUM_SEEDS,
                               **({"fps_segments": 1} if stage == "2" or preset == "exact"
                                  else {}))
    if width_mult != 1:
        cfg = scale_pipeline_widths(cfg, width_mult)
    if dtype == "bf16":
        cfg = set_pipeline_dtype(cfg, torch.bfloat16)
    return cfg


def peaks_for(cfg) -> rf.Peaks:
    """``H100_SXM_BF16`` where the config's MLPs compute in bfloat16, else
    ``H100_SXM``."""
    return rf.H100_SXM_BF16 if cfg.gspn.dtype == torch.bfloat16 else rf.H100_SXM


def stage_costs(cfg, stage: str, b: int, n: int, gt_size: int = 256) -> dict[str, rf.Cost]:
    """``pipeline_cost`` of a request, or ``train_step_cost`` of a step."""
    if stage == "infer":
        return rf.pipeline_cost(cfg, b, n)
    return rf.train_step_cost(cfg, b, n, gt_size=gt_size, stage=int(stage))


def floor_lines(stages: dict[str, rf.Cost], peaks: rf.Peaks) -> list[str]:
    """One line a stage: ms on the matmul, element-wise and HBM roofs, the
    floor and its roof."""
    out = [f"{'stage':<24s} {'mxu_ms':>10s} {'vpu_ms':>10s} {'hbm_ms':>10s} "
           f"{'floor_ms':>10s} bound  ({peaks.name})"]
    for name, c in stages.items():
        f = c.floors(peaks)
        out.append(f"{name:<24s} {f['mxu'] * 1e3:10.5f} {f['vpu'] * 1e3:10.5f} "
                   f"{f['hbm'] * 1e3:10.5f} {f['floor'] * 1e3:10.5f} {f['bound']}")
    return out


def kernel_cost(name: str, args) -> rf.Cost:
    """The model's per-op cost of one launch of kernel ``name`` (a key of
    ``ops.KERNELS``) on ``args``, laid out as ``time_kernels.cases`` gives
    them: fps and fps_cluster ``fps_cost``; the ball groups and queries
    ``ball_group_cost``; the box groups ``ball_group_cost`` at one scale
    of S (the model counts the RoIAlign as a gather and has no box query
    of its own); three_nn ``three_nn_cost``; interp_mm
    ``interpolate_mm_cost`` (the TPU's dense product, not the three rows a
    target that the kernel reads); mask_project(_boxed)
    ``mask_project_cost``; nms ``nms_cost``; nn_argmin ``chamfer_cost``;
    index_add ``gather_cost`` (a gather's backward moves the same rows)."""
    if name in ("fps", "fps_cluster"):
        npoint, xyz = args[:2]
        return rf.fps_cost(xyz.shape[0], xyz.shape[1], npoint)
    if name.startswith(("ball_group", "ball_query")):
        _, ks, xyz, q = args[:4]
        return rf.ball_group_cost(xyz.shape[0], q.shape[1], xyz.shape[1], tuple(ks))
    if name.startswith("box_group"):
        boxes, s, xyz = args[:3]
        return rf.ball_group_cost(xyz.shape[0], boxes.shape[1], xyz.shape[1], (s,))
    if name == "three_nn":
        tgt, src = args[:2]
        return rf.three_nn_cost(tgt.shape[0], tgt.shape[1], src.shape[1])
    if name == "interp_mm":
        pts, idx = args[:2]
        return rf.interpolate_mm_cost(pts.shape[0], idx.shape[1], pts.shape[1], pts.shape[2])
    if name.startswith("mask_project"):
        xyz, samp = args[:2]
        return rf.mask_project_cost(xyz.shape[0], samp.shape[1], xyz.shape[1], samp.shape[2])
    if name == "nms":
        boxes = args[0]
        return rf.nms_cost(boxes.shape[0], boxes.shape[1])
    if name == "nn_argmin":
        a, b = args[:2]
        return rf.chamfer_cost(a.shape[0], a.shape[1], b.shape[1])
    if name == "index_add":
        src = args[0]
        return rf.gather_cost(src.shape[0] * src.shape[1], src.shape[2])
    raise ValueError(f"no model cost for kernel {name!r}")


def _scenes(b: int, n: int):
    """The bench's scenes where ``(b, n)`` is one of ``bench_slice.SHAPES``,
    else ``scene_batch(default_rng(0), b, n_points=n, max_instances=8)``."""
    from gspn_tpu_torch.data import synthetic
    from gspn_tpu_torch.utils import bench_slice

    shape = f"B{b}xN{n}"
    if shape in bench_slice.SHAPES:
        return bench_slice.scenes(shape)
    sb = synthetic.scene_batch(np.random.default_rng(0), b, n_points=n, max_instances=8)
    return sb["xyz"], sb["valid"]


def request_fn(cfg, b: int, n: int, device, way: str = "eager", work=None):
    """A request of ``cfg`` at ``b`` x ``n`` on seeded weights
    (``bench_slice.seeded_model``) and noise (seed 1): ``make_inference_fn``
    eagerly under ``inference_mode`` ("eager"), or the model exported to
    ``work`` and replayed by ``InferenceSession.run`` ("session")."""
    from gspn_tpu_torch.models.pipeline import make_inference_fn
    from gspn_tpu_torch.utils import bench_slice

    model = bench_slice.seeded_model(cfg, device)
    xyz, valid = (torch.from_numpy(a).to(device) for a in _scenes(b, n))
    eps = torch.randn((b, cfg.num_seeds, cfg.gspn.latent_dim),
                      generator=torch.Generator().manual_seed(1)).to(device)
    if way == "eager":
        infer = make_inference_fn(cfg)

        def call():
            with torch.inference_mode():
                return infer(model, xyz, valid, z_eps=eps)
        return call
    if way != "session":
        raise ValueError(f"way must be eager|session, got {way!r}")
    from gspn_tpu_torch.serve import InferenceSession, export_inference, save_artifact
    from gspn_tpu_torch.serve.export import serving_state

    program = export_inference(cfg, model, n, batch_size=b, device=device)
    path = save_artifact(pathlib.Path(work) / f"roofline_B{b}xN{n}.gspnt", program, cfg)
    session = InferenceSession(path, serving_state(model), device=device)
    return lambda: session.run(xyz, valid, eps)


def step_fn(cfg, stage: str, b: int, n: int, device, gt_size: int = 256):
    """A training step of ``stage`` ("1" or "2") at ``b`` x ``n``
    (``bench_slice.train_batch``), seeded weights, Adam at 1e-3, the same
    noise each step: stage 1 as ``chip_smoke.py`` slice (G) takes it (its
    ``num_seeds`` seeds, ``gt_size`` GT points a seed), stage 2 as slice
    (I) (a seeded frozen GSPN, ``bench_slice.STAGE2_INSTANCES`` GT boxes)."""
    from gspn_tpu_torch.train.steps import (
        TrainState, make_gspn_loss_fn, make_optimizer, make_rpointnet_loss_fn, make_train_step,
    )
    from gspn_tpu_torch.utils import bench_slice

    batch = bench_slice.train_batch(device, b, n)
    gen = torch.Generator().manual_seed(1)
    if stage == "1":
        model = bench_slice.seeded_gspn(cfg.gspn, device)
        step = make_train_step(make_gspn_loss_fn(cfg.num_seeds, gt_size))
        draws = {"z_eps": torch.randn((b, cfg.num_seeds, cfg.gspn.latent_dim),
                                      generator=gen).to(device)}
    elif stage == "2":
        model = bench_slice.seeded_rpointnet(cfg.rpointnet, device)
        frozen = bench_slice.seeded_frozen_gspn(cfg.gspn, device)
        step = make_train_step(make_rpointnet_loss_fn(bench_slice.STAGE2_INSTANCES,
                                                      (frozen, cfg.num_seeds)))
        draws = {"box_noise": torch.randn((b, bench_slice.STAGE2_INSTANCES, 6),
                                          generator=gen).to(device),
                 "z_eps": torch.randn((b, cfg.num_seeds, cfg.gspn.latent_dim),
                                      generator=gen).to(device)}
    else:
        raise ValueError(f"a training stage is 1 or 2, got {stage!r}")
    state = TrainState(model, make_optimizer(model, 1e-3))
    return lambda: step(state, batch, **draws)


def timed(fn, n: int) -> list[float]:
    """Seconds of each of ``n`` calls of ``fn`` after a warm-up, each one
    ``time_fn`` of a single synchronized call."""
    sync(fn())
    return [time_fn(fn, iters=1, warmup=0) for _ in range(n)]


def report(cost: rf.Cost, seconds: list[float], peaks: rf.Peaks) -> dict:
    """``cost.report`` at the median of ``seconds``, in ms, with the min
    and max beside it."""
    med = statistics.median(seconds)
    r = cost.report(med, peaks)
    return {"measured_ms": med * 1e3, "min_ms": min(seconds) * 1e3,
            "max_ms": max(seconds) * 1e3, "calls": len(seconds),
            "floor_ms": r["floor"] * 1e3, "bound": r["bound"],
            "frac_of_roof": r["frac_of_roof"], "mfu": r["mfu"], "peaks": peaks.name}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", choices=STAGES, default="infer")
    ap.add_argument("--preset", choices=PRESETS, default="scannet")
    ap.add_argument("--batch", type=int, default=None, help="default 8 (infer) or 4 (training)")
    ap.add_argument("--num-points", type=int, default=None,
                    help="default 8192 (infer) or 4096 (training)")
    ap.add_argument("--gt-size", type=int, default=256)
    ap.add_argument("--width-mult", type=int, default=1)
    ap.add_argument("--dtype", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--measure", action="store_true",
                    help="time the call on the card (needs a CUDA device)")
    ap.add_argument("--way", choices=["eager", "session"], default="eager",
                    help="a request's way in (--stage infer)")
    ap.add_argument("--requests", type=int, default=20, help="timed calls after a warm-up")
    args = ap.parse_args(argv)
    train = args.stage != "infer"
    b = args.batch or (4 if train else 8)
    n = args.num_points or (4096 if train else 8192)
    cfg = pipeline_config(args.stage, args.preset, n, args.width_mult, args.dtype)
    peaks = peaks_for(cfg)
    stages = stage_costs(cfg, args.stage, b, n, args.gt_size)
    print(f"roofline: stage {args.stage}, preset {args.preset}, B={b} x N={n}, "
          f"width x{args.width_mult}, {args.dtype}; peaks {peaks.name}: matmul "
          f"{peaks.mxu_flops / 1e12:g} TFLOP/s, element-wise {peaks.vpu_ops / 1e12:g} T/s, "
          f"HBM {peaks.hbm_bytes / 1e12:g} TB/s")
    print("\n".join(floor_lines(stages, peaks)), flush=True)
    if not args.measure:
        return
    if not torch.cuda.is_available():
        raise SystemExit("profile_roofline --measure: needs a CUDA device")
    from gspn_tpu_torch.utils import bench_slice
    from gspn_tpu_torch.utils.time_kernels import card_name

    bench_slice.pin_float32_matmuls()
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as work:
        fn = (step_fn(cfg, args.stage, b, n, dev, args.gt_size) if train
              else request_fn(cfg, b, n, dev, args.way, work))
        seconds = timed(fn, args.requests)
    print(json.dumps({"stage": args.stage, "preset": args.preset, "batch": b, "points": n,
                      "width_mult": args.width_mult, "dtype": args.dtype,
                      **({"way": args.way} if not train else {}),
                      **report(stages["total"], seconds, peaks), "card": card_name()}))


if __name__ == "__main__":
    main()
