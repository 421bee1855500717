"""A serving cell's load sweep on the card, in one process: the session
exported and captured once, then the open loop of ``serve.py`` at each
number of client threads and each offered rate, one window each:

    python bench_h100/sweep.py --workload <cell> --clients 1,2,4,8,16 \\
        --rates 1000 [--below 0.8] [--seconds 10] [--seed 1] [--out chiprun_out/sweep.jsonl]

A rate far above what the session sustains reads its capacity with that
many clients (the knee); a rate under it reads the tail of the latencies.
``--below f`` follows each window with one at ``f`` times the rate it
completed, with the same clients.
One JSON line a window: requests started and completed in it, requests
and valid points a second, the 50th and 95th percentile of the latencies
from when each request was due, failures. The answers are not checked:
``run.py`` and ``calibrate.py`` do that. The cell's ``rate`` and
``clients`` are chosen from these readings (``PERF.md``)."""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--clients", default="1,2,4,8,16")
    p.add_argument("--rates", default="1000")
    p.add_argument("--below", type=float, default=0.0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default="chiprun_out/sweep.jsonl")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench_h100 import run

    run.use_checkout_caches()
    import torch

    from bench_h100 import manifest, program, scenes, serve, stats

    man = manifest.load(ROOT)
    cell = manifest.workload(man, args.workload)
    cfg, traffic = manifest.config(cell["config"]), manifest.traffic(cell["traffic"])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    clients = [int(c) for c in args.clients.split(",")]
    rates = [float(r) for r in args.rates.split(",")]
    t0 = time.perf_counter()
    state, pool, order = serve.inputs(cfg, traffic, args.seed, device)
    points = [int(b["valid"].sum()) for b in pool]
    workdir = tempfile.mkdtemp(prefix="bench_h100_sweep_")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    try:
        session = program.session(cfg, state, traffic["batch"], traffic["points"], device,
                                  workdir)
        serve.open_loop(session, pool, order, scenes.seed_int(args.seed, 4), 0, float("inf"),
                        float("inf"), max(clients), requests=2 * max(clients))
        setup = time.perf_counter() - t0
        i = 0
        with out.open("a") as f:
            for c in clients:
                for rate in rates:
                    offered = [rate]
                    while offered:
                        r = offered.pop()
                        res = serve.open_loop(session, pool, order, args.seed, i, args.seconds,
                                              r, c)
                        done, pts, lat = serve.completed(res, points, order, i, args.seconds)
                        i = res["next"]
                        row = {"workload": args.workload, "seed": args.seed, "clients": c,
                               "rate": r, "seconds": args.seconds, "setup_s": setup,
                               "started": res["started"], "completed": done,
                               "requests_per_s": stats.rate(done, args.seconds),
                               "points_per_s": stats.rate(pts, args.seconds),
                               "p50_ms": stats.percentile(lat, 50) * 1e3 if lat else None,
                               "p95_ms": stats.percentile(lat, 95) * 1e3 if lat else None,
                               "failed": res["failed"],
                               "card": torch.cuda.get_device_name(device)}
                        line = json.dumps(row)
                        print(line, flush=True)
                        f.write(line + "\n")
                        if r == rate and args.below > 0:
                            offered.append(args.below * row["requests_per_s"])
        del session
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
