"""Host ms of the eager paths users call, for one checkout: a request of
slice (A) (``make_inference_fn(bench_slice.slice_config())`` at the
flagship B=8 x N=8192 and the whole scene B=1 x N=65536), a stage-1
training step of slice (G) and a stage-2 step of slice (I), each on the
host clock around a synchronized call, median (min-max) of ``--requests``
requests or ``--steps`` steps after a warm-up.

    python gspn_tpu_torch/utils/host_ms.py [--tree DIR] [--requests 40] [--steps 20]

``--tree DIR`` imports ``gspn_tpu_torch`` from another checkout (for
example the parent commit unpacked with ``git archive``), so that two
versions of the eager path compare on one card in one call: run the
parent, the change, the change and the parent in turn. Prints one JSON
line with the card's name and power limit. Needs a CUDA device.

Nothing here imports ``gspn_tpu_torch`` at module level: ``--tree``
decides which one it times.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import sys
import time

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]


def _ms(fn, n: int) -> list[float]:
    """One warm-up call of ``fn``, then ``n`` timed ones, each on the host
    clock around a synchronized call."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _summary(times: list[float]) -> dict:
    return {"median": statistics.median(times), "min": min(times), "max": max(times),
            "n": len(times)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(REPO), help="checkout whose gspn_tpu_torch is timed")
    ap.add_argument("--requests", type=int, default=40, help="timed requests a shape")
    ap.add_argument("--steps", type=int, default=20, help="timed training steps a slice")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree]
    from gspn_tpu_torch.models.pipeline import make_inference_fn
    from gspn_tpu_torch.ops import _cuda
    from gspn_tpu_torch.train import steps
    from gspn_tpu_torch.utils import bench_slice
    from gspn_tpu_torch.utils.time_kernels import card_name

    if not torch.cuda.is_available():
        raise SystemExit("host_ms: needs a CUDA device")
    if not _cuda.__file__.startswith(tree):
        raise SystemExit(f"host_ms: imported {_cuda.__file__}, not from {tree}")
    dev = torch.device("cuda", 0)
    bench_slice.float32_matmuls()
    _cuda.library()
    out = {"tree": args.tree, "card": card_name()}

    cfg = bench_slice.slice_config()
    model = bench_slice.seeded_model(cfg, dev)
    infer = make_inference_fn(cfg)
    with torch.inference_mode():
        for seed, shape in enumerate(bench_slice.SHAPES, start=1):
            xyz, valid, eps = bench_slice.request(cfg, shape, dev, seed)
            out[f"A {shape} ms/request"] = _summary(
                _ms(lambda: infer(model, xyz, valid, z_eps=eps), args.requests))

    gcfg = bench_slice.train_config()
    batch = bench_slice.train_batch(dev)
    gspn = bench_slice.seeded_gspn(gcfg, dev)
    eps = torch.randn((bench_slice.TRAIN_BATCH, bench_slice.TRAIN_SEEDS, gcfg.latent_dim),
                      generator=torch.Generator().manual_seed(1)).to(dev)
    step = steps.make_train_step(steps.make_gspn_loss_fn(bench_slice.TRAIN_SEEDS,
                                                         bench_slice.TRAIN_GT))
    state = steps.TrainState(gspn, steps.make_optimizer(gspn, 1e-3))
    out["G ms/step"] = _summary(_ms(lambda: step(state, batch, z_eps=eps), args.steps))

    fcfg, rcfg = bench_slice.stage2_configs()
    frozen = bench_slice.seeded_frozen_gspn(fcfg, dev)
    rpn = bench_slice.seeded_rpointnet(rcfg, dev)
    gen = torch.Generator().manual_seed(1)
    b = batch["xyz"].shape[0]
    draws = {"box_noise": torch.randn((b, bench_slice.STAGE2_INSTANCES, 6), generator=gen),
             "z_eps": torch.randn((b, bench_slice.TRAIN_SEEDS, fcfg.latent_dim), generator=gen)}
    draws = {k: v.to(dev) for k, v in draws.items()}
    step2 = steps.make_train_step(steps.make_rpointnet_loss_fn(
        bench_slice.STAGE2_INSTANCES, (frozen, bench_slice.TRAIN_SEEDS)))
    state2 = steps.TrainState(rpn, steps.make_optimizer(rpn, 1e-3))
    out["I ms/step"] = _summary(_ms(lambda: step2(state2, batch, **draws), args.steps))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
