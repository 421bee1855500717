#!/usr/bin/env python3
"""Where the PyTorch port's inference slice spends its time on the card.

    python3 -m gspn_tpu_torch.utils.profile_slice [--variant NAME] [--out DIR]

Runs slices (A) and (B) of ``chip_smoke.py`` (``utils.bench_slice.
slice_config``: ``scannet_pipeline()`` with the thresholds moved, and its
"prune" variant; seeded weights, the bench's scenes), or with ``--variant``
only that variant of ``bench_slice.variant_config`` (``strided`` is slice
(E)), at B=8 x N=8192 and B=1 x N=65536 under ``torch.profiler``,
``ITERS`` requests after a warm-up, and prints per slice and shape: wall
ms per request, device busy
ms (the union of kernel intervals on the timeline) and the idle share, the
device time and launches per request of each hand-written kernel, and the
top device kernels by time. Writes a Chrome trace per slice and shape to
``--out`` (default ``runs/profile``, gitignored). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from gspn_tpu_torch.models.pipeline import make_inference_fn
from gspn_tpu_torch.utils import bench_slice
from gspn_tpu_torch.utils.profiling import busy_us, device_kernels

HAND_WRITTEN = (  # symbols in the profiler's demangled device events
    "fps_kernel", "fps_cluster_kernel", "group_first_kernel", "group_strided_kernel",
    "three_nn_kernel", "interp_mm_kernel", "nearest_logit_kernel", "nms_kernel",
    "nn_argmin_kernel", "index_add_kernel",
)
ITERS = 5


def profile(label, infer, model, xyz, valid, eps, out_dir):
    from torch.profiler import ProfilerActivity, profile as tprofile

    with torch.inference_mode():
        for _ in range(2):
            infer(model, xyz, valid, z_eps=eps)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                infer(model, xyz, valid, z_eps=eps)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    kernels = device_kernels(prof)
    busy_ms = busy_us(kernels) / 1e3 / ITERS
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += (e.time_range.end - e.time_range.start) / 1e3 / ITERS
        d[1] += 1
    hand_written = {h: [0.0, 0] for h in HAND_WRITTEN}
    for k, (ms, count) in by_name.items():
        for h in HAND_WRITTEN:
            if h in k:
                hand_written[h][0] += ms
                hand_written[h][1] += count / ITERS
    hand = sum(v[0] for v in hand_written.values())
    total = sum(v[0] for v in by_name.values())
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / f"trace_{label}.json"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "run": label, "wall_ms_per_request": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms, "kernel_sum_ms": total,
        "hand_written_kernel_ms": hand, "launches_per_request": len(kernels) / ITERS,
        "hand_written": {h: v for h, v in hand_written.items() if v[1]},
        "top": [[k[:90], round(v[0], 4), v[1] // ITERS] for k, v in top],
    }))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", choices=bench_slice.VARIANTS,
                    help="profile only this variant of the slice")
    ap.add_argument("--out", default="runs/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA device")
    dev = torch.device("cuda", 0)
    bench_slice.pin_float32_matmuls()
    cfg = bench_slice.slice_config()
    model = bench_slice.seeded_model(cfg, dev)
    runs = ((args.variant, bench_slice.variant_config(args.variant)),) if args.variant else (
        ("A", cfg), ("B", bench_slice.variant_config("prune")))
    for name, scfg in runs:
        infer = make_inference_fn(scfg)
        smodel = bench_slice.rebuilt_model(scfg, model)  # modules keep their config
        for seed, shape in enumerate(bench_slice.SHAPES, start=1):
            xyz, valid, eps = bench_slice.request(scfg, shape, dev, seed)
            profile(f"{name}_{shape}", infer, smodel, xyz, valid, eps, pathlib.Path(args.out))


if __name__ == "__main__":
    main()
