"""Timing of the hand-written kernels on the card, and the fps and first-K
ball group cases at every shape the main path gives them.

    python gspn_tpu_torch/utils/time_kernels.py [--tree DIR]

``chip_smoke.py``'s kernel phase times every kernel with ``cuda_ms`` and
``device_ms``, holds it against its plain version with ``max_abs_err``,
and takes its fps and ball_group shapes from ``cases``. Run as a script,
this module times fps and ball_group alone at those shapes, importing
``gspn_tpu_torch`` from ``--tree DIR`` (another checkout, for example the
parent commit unpacked with ``git archive``), so that two versions of the
kernels compare on one card in one call: run it for the parent, the
change, the change and the parent in turn. Each line gives the kernel's
device time and the wrapper's, each over 20 launches after a warm-up, with
the card's name and power limit; every kernel output is first held bitwise
against the plain version. Needs a CUDA device.

Nothing here imports ``gspn_tpu_torch`` at module level: the script's
``--tree`` decides which one it times.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
ITERS = 20  # timed launches a case
PROFILER_WINDOWS = 3  # tries at a profiler window that records the kernel
# the kernels' device symbols, before (group_scan_kernel) and after their
# redesign, so that either tree's kernels are found
SYMBOLS = {
    "fps": ("fps_kernel",),
    "ball_group": ("ball_group_first_kernel", "group_scan_kernel<false, false, true>"),
}


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
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


def device_ms(fn, iters: int, symbols: tuple[str, ...]) -> tuple[float | None, int]:
    """``(mean device ms per launch, events)`` of the kernel (any of
    ``symbols``) over ``iters`` calls of ``fn`` (one launch each) after a
    warm-up, from ``torch.profiler``'s device events: the kernel alone,
    without its wrapper's host work or other device work. The mean is over
    the ``events`` the profiler recorded, which may be fewer than
    ``iters``. Now and then a profiler window records no device event at
    all (seen once in about 240 windows on an H100); the window is then
    taken again, up to ``PROFILER_WINDOWS`` times, and ``(None, 0)`` means
    none recorded one (the kernel's launches and outputs are checked apart
    from this)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        mine = [e for e in device if any(sym in e.name for sym in symbols)]
        if mine:
            ms = sum(e.time_range.end - e.time_range.start for e in mine) / 1e3 / len(mine)
            return ms, len(mine)
        print(f"profiler: no device event of {symbols} among "
              f"{sorted({e.name for e in device})}; window taken again")
    return None, 0


def max_abs_err(got, want) -> float:
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


def flatten(outs) -> list:
    """A kernel's outputs (a tensor, or nested tuples and lists of them)
    as one list of tensors."""
    if isinstance(outs, torch.Tensor):
        return [outs]
    return [t for o in outs for t in flatten(o)]


def call(ops, name: str, args, impl: str):
    """The entry point of ``name`` ("fps" or "ball_group") on a case's
    ``args``."""
    if name == "fps":
        return ops.farthest_point_sample(*args, impl=impl)
    return ops.query_ball_group_multi(*args, impl=impl)


def cases(ops, bench_slice, dev) -> dict:
    """``{"fps": [(label, (npoint, xyz, valid))], "ball_group": [(label,
    (radii, ks, xyz, centres, valid))]}`` at the main path's shapes, the
    flagship's first (the shared FPS pass, SA1): the shared pass, crops
    and SA1-SA4 of the flagship and of the whole scene (``bench_slice``'s
    scenes), and the training step's seeds and crops."""
    out = {"fps": [], "ball_group": []}
    for shape in ("B8xN8192", "B1xN65536"):
        xyz, valid = (torch.from_numpy(a).to(dev) for a in bench_slice.scenes(shape))
        b, n = xyz.shape[:2]
        tag = "" if b > 1 else ", whole scene"
        sxyz, svalid, sidx = ops.spatial_sorted_view(xyz, valid)
        seeds = ops.gather_point(xyz, torch.gather(sidx, 1, ops.farthest_point_sample(
            64, sxyz, svalid, segments=8, segment_mode="contiguous").long()))
        sa = [ops.gather_point(xyz, ops.farthest_point_sample(
            1024, xyz, valid, segments=8, segment_mode="spatial"))]
        out["fps"].append((f"shared pass: {b * 8} chains x {n // 8} pts, 128 picks{tag}",
                           (128, sxyz.reshape(b * 8, n // 8, 3), svalid.reshape(b * 8, n // 8))))
        out["ball_group"] += [
            (f"sa1: {b}x1024 q over {n}, r 0.1, K 32{tag}", ((0.1,), (32,), xyz, sa[0], valid)),
            (f"gspn crops: {b}x64 seeds, r .25/.5/1, K 32/64/128{tag}",
             ((0.25, 0.5, 1.0), (32, 64, 128), xyz, seeds, valid)),
        ]
        for npoint, r in ((256, 0.2), (64, 0.4), (16, 0.8)):
            src = sa[-1]
            segs = ops.eligible_fps_segments(8, npoint, src.shape[1])
            chains = ops.spatial_sorted_view(src, None)[0] if segs > 1 else src
            chains = chains.reshape(b * segs, src.shape[1] // segs, 3)
            sa.append(ops.gather_point(src, ops.farthest_point_sample(
                npoint, src, segments=segs, segment_mode="spatial")))
            lvl = len(sa)
            out["fps"].append((f"sa{lvl}: {chains.shape[0]} x {chains.shape[1]} pts, "
                               f"{npoint // segs} picks{tag}", (npoint // segs, chains, None)))
            out["ball_group"].append((f"sa{lvl}: {b}x{npoint} q over {src.shape[1]}, r {r}, "
                                      f"K 32{tag}", ((r,), (32,), src, sa[-1], None)))
    tb = bench_slice.train_batch(dev)
    tseeds = ops.gather_point(tb["xyz"], ops.farthest_point_sample(64, tb["xyz"], tb["valid"]))
    out["fps"].append(("training seeds: 4 x 4096 pts, 64 picks", (64, tb["xyz"], tb["valid"])))
    out["ball_group"].append(("training crops: 4x64 seeds over 4096, K 64/128/256",
                              ((0.25, 0.5, 1.0), (64, 128, 256), tb["xyz"], tseeds, tb["valid"])))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(REPO), help="checkout whose gspn_tpu_torch is timed")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree]
    from gspn_tpu_torch import ops
    from gspn_tpu_torch.utils import bench_slice

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA device")
    if not ops.__file__.startswith(tree):
        raise SystemExit(f"time_kernels: imported {ops.__file__}, not from {tree}")
    card = card_name()
    bench_slice.float32_matmuls()
    for name, items in cases(ops, bench_slice, torch.device("cuda", 0)).items():
        for label, a in items:
            fn = lambda impl, a=a, name=name: call(ops, name, a, impl)  # noqa: E731
            max_abs_err(flatten(fn("cuda")), flatten(fn("plain")))
            dev_ms, events = device_ms(lambda fn=fn: fn("cuda"), ITERS, SYMBOLS[name])
            ms = cuda_ms(lambda fn=fn: fn("cuda"), ITERS)
            print(f"time {name} [{label}] tree {args.tree}: device {dev_ms} ms over {events} "
                  f"events, wrapper {ms:.4f} ms; bitwise plain [{card}]", flush=True)


if __name__ == "__main__":
    main()
