#!/usr/bin/env python3
"""Drive the PyTorch port's inference slice once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero without them. Phases,
each printing one line or a few:

1. device: the card's name and power limit, CUDA and nvcc versions;
2. build: compiles the hand-written kernels (``gspn_tpu_torch/csrc``);
3. kernels: each kernel against its plain PyTorch version at the slice's
   shapes (integer outputs equal, coordinates and distances bitwise), with
   both times from CUDA events;
4. slice: ``scannet_pipeline()`` with ``mask_project="3nn"`` (and
   thresholds for random weights, see ``gspn_tpu_torch.utils.bench_slice``)
   at full width, seeded weights, on the bench's scenes: per shape
   (B=8 x N=8192, then the whole scene B=1 x N=65536) one warm-up and
   ``REQUESTS`` timed requests through the kernels (every kernel's launch
   count must grow), then the same inputs through the plain ops on the card
   (identical masks, valid and classes; scores and boxes within rtol 1e-4 /
   atol 1e-5; as many timed requests), and a small scene on the CPU as a
   second reference;
5. a JSON line of kernel results, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises; no phase's error is caught. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import time

import numpy as np
import torch

B, N = 8, 8192  # flagship request: 8 scenes x 8192 points
WS_N = 65536  # whole-scene request: 1 scene, last 10% of points padding
FLAGSHIP, WHOLE_SCENE = "B8xN8192", "B1xN65536"  # keys of bench_slice.SHAPES
REQUESTS = 20  # timed requests per shape and path, after one warm-up
KERNEL_ITERS = 20  # timed launches per kernel and per plain version


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(fn) -> tuple[float, object]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _max_abs_err(got, want) -> float:
    """Max |got - want| over matching outputs; raises unless every pair is
    exactly equal (integers) or bitwise equal (floats)."""
    err = 0.0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        err = max(err, (g.double() - w.double()).abs().max().item() if g.numel() else 0.0)
        if not torch.equal(g, w):
            raise AssertionError(f"kernel differs from its plain version (max abs err {err})")
    return err


def _flatten(outs):
    if isinstance(outs, torch.Tensor):
        return [outs]
    return [t for o in outs for t in _flatten(o)]


def check_kernels(dev, ops, bench_slice):
    """Phase 3. Returns the JSON entries (time at each kernel's main shape)."""
    xyz, valid = (torch.from_numpy(a).to(dev) for a in bench_slice.scenes(FLAGSHIP))
    ws, wsv = (torch.from_numpy(a).to(dev) for a in bench_slice.scenes(WHOLE_SCENE))

    # the slice's shapes: 8 spatial FPS chains per scene, 128 picks each
    sxyz, svalid, sidx = ops.spatial_sorted_view(xyz, valid)
    wsx, wsvv, _ = ops.spatial_sorted_view(ws, wsv)
    seeds = ops.gather_point(xyz, torch.gather(sidx, 1, ops.farthest_point_sample(
        64, sxyz, svalid, segments=8, segment_mode="contiguous").long()))
    sa1 = ops.gather_point(xyz, ops.farthest_point_sample(1024, xyz, valid, segments=8,
                                                           segment_mode="spatial"))
    gen = torch.Generator().manual_seed(0)
    half = (torch.rand((B, 64, 3), generator=gen) * 0.5 + 0.1).to(dev)
    boxes = torch.cat([seeds - half, seeds + half], dim=-1)
    roi_xyz = ops.query_box_group(boxes, 64, xyz, valid)[2] + (
        (boxes[..., 0:3] + boxes[..., 3:6]) * 0.5)[..., None, :]
    targets = xyz[:, None].expand(B, 64, N, 3).reshape(B * 64, N, 3)

    cases = {  # name -> [(shape label, fn(impl))], main shape first
        "fps": [
            (f"{B}x8 chains x {N // 8} pts, 128 picks",
             lambda impl: ops.farthest_point_sample(
                 128, sxyz.reshape(B * 8, N // 8, 3), svalid.reshape(B * 8, N // 8),
                 impl=impl)),
            (f"1x8 chains x {WS_N // 8} pts, 128 picks (whole scene)",
             lambda impl: ops.farthest_point_sample(
                 128, wsx.reshape(8, WS_N // 8, 3), wsvv.reshape(8, WS_N // 8),
                 impl=impl)),
        ],
        "ball_group": [
            (f"sa1: {B}x1024 queries, r 0.1, K 32",
             lambda impl: ops.query_ball_group_multi(
                 (0.1,), (32,), xyz, sa1, valid, impl=impl)),
            (f"gspn crops: {B}x64 seeds, r .25/.5/1, K 32/64/128",
             lambda impl: ops.query_ball_group_multi(
                 (0.25, 0.5, 1.0), (32, 64, 128), xyz, seeds, valid, impl=impl)),
        ],
        "box_group": [
            (f"{B}x64 RoIs, S 64",
             lambda impl: ops.query_box_group(boxes, 64, xyz, valid, impl=impl)),
        ],
        "three_nn": [
            (f"fp4: {B}x{N} targets <- 1024",
             lambda impl: ops.three_nn(xyz, sa1, impl=impl)),
            (f"3nn masks: {B * 64}x{N} targets <- 64",
             lambda impl: ops.three_nn(targets, roi_xyz.reshape(B * 64, 64, 3), impl=impl)),
        ],
    }
    entries = []
    for name, shapes in cases.items():
        k = ops.KERNELS[name]
        main = None
        for label, fn in shapes:
            err = _max_abs_err(_flatten(fn("cuda")), _flatten(fn("plain")))
            ms = _cuda_ms(lambda fn=fn: fn("cuda"), KERNEL_ITERS)
            plain_ms = _cuda_ms(lambda fn=fn: fn("plain"), KERNEL_ITERS)
            print(f"kernel {name} [{label}]: equal to plain (max abs err {err}); "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if main is None:
                main = (err, ms, plain_ms)
        entries.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces.split()[0], "launches": 0,
            "max_abs_err": main[0], "ms": main[1], "plain_ms": main[2],
        })
    return entries


def _timed_requests(infer, model, req):
    """One warm-up request, then ``REQUESTS`` timed ones on the host clock
    around a synchronized call. Returns ``(ms per request, output)`` and
    raises unless every timed request gave the same output."""
    xyz, valid, eps = req
    infer(model, xyz, valid, z_eps=eps)
    times, first = [], None
    for _ in range(REQUESTS):
        ms, out = _host_ms(lambda: infer(model, xyz, valid, z_eps=eps))
        times.append(ms)
        if first is None:
            first = out
            continue
        for f in ("masks", "valid", "classes", "scores", "boxes"):
            if not torch.equal(getattr(out, f), getattr(first, f)):
                raise AssertionError(f"repeated requests differ in {f}")
    return times, first


def _spread(times) -> str:
    return (f"median {statistics.median(times):.3f} ms/batch (min {min(times):.3f}, "
            f"max {max(times):.3f}; {len(times)} requests after a warm-up)")


def run_slice(dev, ops, bench_slice, card):
    """Phase 4. Returns the launch counts of the kernel-path run."""
    from gspn_tpu_torch.data import synthetic
    from gspn_tpu_torch.models.pipeline import make_inference_fn

    cfg = bench_slice.slice_config()
    plain_cfg = dataclasses.replace(
        cfg,
        gspn=dataclasses.replace(cfg.gspn, ops_impl="plain"),
        rpointnet=dataclasses.replace(cfg.rpointnet, ops_impl="plain"),
    )
    model = bench_slice.seeded_model(cfg, dev)
    infer, infer_plain = make_inference_fn(cfg), make_inference_fn(plain_cfg)
    reqs = {shape: bench_slice.request(cfg, shape, dev, seed)
            for seed, shape in enumerate((FLAGSHIP, WHOLE_SCENE), start=1)}

    with torch.inference_mode():
        ops.reset_launch_counts()
        kernel = {shape: _timed_requests(infer, model, req) for shape, req in reqs.items()}
        counts = ops.launch_counts()
        print(f"slice launches: {json.dumps(counts)}")
        missing = [k for k, c in counts.items() if c == 0]
        if missing:
            raise AssertionError(f"the slice never launched kernels {missing}")

        plain = {shape: _timed_requests(infer_plain, model, req) for shape, req in reqs.items()}
        for shape, (_, got) in kernel.items():
            want = plain[shape][1]
            b, n_pts = reqs[shape][1].shape
            if tuple(got.masks.shape) != (b, cfg.num_seeds, n_pts):
                raise AssertionError(f"{shape}: masks shape {tuple(got.masks.shape)}")
            for f in ("scores", "boxes"):
                if not torch.isfinite(getattr(got, f)).all():
                    raise AssertionError(f"{shape}: non-finite {f}")
            for f in ("masks", "valid", "classes"):
                if not torch.equal(getattr(got, f), getattr(want, f)):
                    raise AssertionError(f"{shape}: kernel path and plain path differ in {f}")
            for f in ("scores", "boxes"):
                torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=1e-4, atol=1e-5)
            print(f"slice {shape}: kernel path == plain path (masks, valid, classes equal; "
                  f"scores, boxes within rtol 1e-4 atol 1e-5); {int(got.valid.sum())} valid "
                  f"instances, {int(got.masks.sum())} mask points")

        # a second reference: the CPU's plain path (the one the CPU tests hold
        # against JAX) on a small scene; matmul sums differ between CPU and
        # GPU, so masks may flip at a logit's threshold: allow 1e-3 of them
        sb = synthetic.scene_batch(np.random.default_rng(0), 1, n_points=2048,
                                   max_instances=4, extent=2.0)
        sx, sv = torch.from_numpy(sb["xyz"]), torch.from_numpy(sb["valid"])
        seps = torch.randn((1, cfg.num_seeds, cfg.gspn.latent_dim),
                           generator=torch.Generator().manual_seed(3))
        gpu = infer(model, sx.to(dev), sv.to(dev), z_eps=seps.to(dev))
        cpu = infer(bench_slice.seeded_model(cfg, torch.device("cpu")), sx, sv, z_eps=seps)
        flips = (gpu.masks.cpu() != cpu.masks).float().mean().item()
        if flips > 1e-3 or not torch.equal(gpu.valid.cpu(), cpu.valid):
            raise AssertionError(f"GPU vs CPU on a small scene: mask flips {flips}, "
                                 f"valid equal {torch.equal(gpu.valid.cpu(), cpu.valid)}")
        torch.testing.assert_close(gpu.boxes.cpu(), cpu.boxes, rtol=1e-4, atol=1e-4)
        print(f"slice B=1 x N=2048: GPU kernel path vs CPU plain path: valid equal, "
              f"mask flips {flips}, boxes within 1e-4")

    for shape, (times, _) in kernel.items():
        points = reqs[shape][0].shape[0] * reqs[shape][0].shape[1]
        print(f"slice {shape} kernel path: {_spread(times)}, "
              f"{points / statistics.median(times) * 1e3:.0f} points/s; "
              f"plain path {_spread(plain[shape][0])} [{card}]")
        print(f"slice {shape} kernel path requests ms: {[round(x, 3) for x in times]}")
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    card = _card()
    from gspn_tpu_torch import ops
    from gspn_tpu_torch.ops import _cuda
    from gspn_tpu_torch.utils import bench_slice

    nvcc = subprocess.run([_cuda.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{nvcc.splitlines()[-1]}")
    bench_slice.float32_matmuls()

    lib, secs = _cuda.build()
    _cuda.library()
    print(f"build: {lib.name} in {secs:.1f} s")

    dev = torch.device("cuda", 0)
    entries = check_kernels(dev, ops, bench_slice)
    counts = run_slice(dev, ops, bench_slice, card)
    for e in entries:
        e["launches"] = counts[e["name"]]
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
