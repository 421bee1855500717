"""The readings the correctness limits are set from, at a cell's own size
on the card, in one process:

    python bench_h100/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2] \\
        [--seconds 2] [--out chiprun_out/calibrate.jsonl]

- program: the cell's run (the window at ``--seconds``, then the check),
  its numbers a seed: the lower readings;
- control: the reference in the program's place, computed with TF32
  matmuls (the nearest precision below the configurations' float32 with
  TF32 off), held against the float32 reference by the same numbers: the
  upper readings;
- fault (training cells, with ``--control``): half of each batch left
  out, the mean taken over the rest, in the reference put in the
  program's place;
- with ``--look`` (training cells): the reference run a second time in
  the program's place, the first three steps and the window's, held
  against its first run by the same numbers (how far the reference's own
  rounding, its atomic scatters included, moves each number); and the
  leaves that set each of the program's window numbers.

Training cells check three steps from inside the window too, from the
program's own state there: their control and fault readings start from
the snapshot the program run of the same seed took (``window_`` names),
so a control seed of a training cell is also a program seed.

One JSON line a reading. ``PERF.md`` gives the readings each limit of a
configuration file was set from."""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def tf32(on: bool):
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def control_numbers(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The control's numbers: the TF32 reference against the float32 one."""
    from bench_h100 import serve, train

    with tf32(False):
        if cfg["kind"] == "pipeline":
            state, pool, order = serve.inputs(cfg, traffic, seed, device)
            sample = serve.Sample(seed).pick(int(traffic["rate"] * 10))
            with tf32(True):
                answers = {i: {k: v.cpu().numpy() for k, v in serve.reference_answer(
                    cfg, traffic, state, pool, order, seed, i, device).items()} for i in sample}
            return serve.reference_check(cfg, traffic, state, pool, order, seed, answers,
                                         device).numbers()
        state, frozen, pool, order = train.inputs(cfg, traffic, seed, device)
        want = train.reference_steps(cfg, state, frozen, pool, order, seed, device)
        with tf32(True):
            got = train.reference_steps(cfg, state, frozen, pool, order, seed, device)
        return _steps_numbers(state, got, want)


def half_batch_numbers(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """A training cell's numbers when half of each batch is left out."""
    from bench_h100 import train

    with tf32(False):
        state, frozen, pool, order = train.inputs(cfg, traffic, seed, device)
        want = train.reference_steps(cfg, state, frozen, pool, order, seed, device)
        got = train.reference_steps(cfg, state, frozen, pool, order, seed, device,
                                    rows=slice(0, traffic["batch"] // 2))
        return _steps_numbers(state, got, want)


def window_numbers(cfg: dict, traffic: dict, seed: int, device, keep: dict) -> dict:
    """The control's and the half-batch fault's numbers of the window's
    steps: ``{"control_tf32": ..., "fault_half_batch": ...}``, each the
    reference from the program's snapshot ``keep`` held against the
    float32 reference from it."""
    from bench_h100 import compare, train

    snap, args = keep["snap"], (cfg, keep["snap"], keep["frozen"], keep["pool"], keep["order"],
                                seed, device)
    with tf32(False):
        want = train.window_reference(*args)
        with tf32(True):
            control = train.window_reference(*args)
        half = train.window_reference(*args, rows=slice(0, traffic["batch"] // 2))
    out = {}
    for name, got in (("control_tf32", control), ("fault_half_batch", half)):
        nums = train.numbers(snap["state"], [float(s["loss"]) for s in got],
                             compare.to_cpu(got[0]["grads"]), compare.to_cpu(got[-1]["state"]),
                             want)
        out[name] = {f"window_{k}": v for k, v in nums.items()}
    return out


def reference_again(cfg: dict, traffic: dict, seed: int, device, keep: dict) -> dict:
    """The reference in the program's place, run a second time, against
    its first run: the first three steps from the seed's weights and the
    window's from the program's snapshot ``keep``."""
    from bench_h100 import compare, train

    snap = keep["snap"]
    args = (cfg, snap, keep["frozen"], keep["pool"], keep["order"], seed, device)
    with tf32(False):
        state, frozen, pool, order = train.inputs(cfg, traffic, seed, device)
        first = [train.reference_steps(cfg, state, frozen, pool, order, seed, device)
                 for _ in range(2)]
        win = [train.window_reference(*args) for _ in range(2)]
    nums = _steps_numbers(state, first[1], first[0])
    again = train.numbers(snap["state"], [float(s["loss"]) for s in win[1]],
                          compare.to_cpu(win[1][0]["grads"]),
                          compare.to_cpu(win[1][-1]["state"]), win[0])
    return {**nums, **{f"window_{k}": v for k, v in again.items()}}


def look(cfg: dict, seed: int, device, keep: dict, top: int = 3) -> dict:
    """The leaves that set the program's window numbers: for each of
    ``grad_norm_gap``, ``change_gap`` and ``bn_stat_gap``, the ``top``
    leaves by gap, each ``[name, gap, program norm, reference norm]``,
    and the median leaf's reference norm."""
    from bench_h100 import compare, train
    from bench_h100.reference import train as ref_train

    snap = keep["snap"]
    with tf32(False):
        want = train.window_reference(cfg, snap, keep["frozen"], keep["pool"], keep["order"],
                                      seed, device)
    b1 = ref_train.ADAM_B1
    grads = compare.to_cpu({k: (snap["m_after"][k] - b1 * m) / (1.0 - b1)
                            for k, (m, _) in snap["moments"].items()})
    ref_grads = compare.to_cpu(want[0]["grads"])
    init, after = compare.to_cpu(snap["state"]), compare.to_cpu(snap["after"])
    last = compare.to_cpu(want[-1]["state"])
    params = train.trainable(snap["state"])
    buffers = sorted(set(snap["state"]) - params)
    gnorm = {k: float(v.norm()) for k, v in ref_grads.items()}
    gmed = float(np.median(list(gnorm.values())))
    moving = [k for k in params if gnorm.get(k, 0.0) >= 1e-3 * gmed]

    def leaves(got: dict, ref: dict, keys) -> dict:
        wn = {k: float(ref[k].norm()) for k in keys}
        gn = {k: float(got[k].norm()) for k in keys}
        med = float(np.median(list(wn.values())))
        gaps = sorted(((abs(gn[k] - wn[k]) / max(wn[k], med, 1e-30), k) for k in keys),
                      reverse=True)
        return {"median": med, "top": [[k, g, gn[k], wn[k]] for g, k in gaps[:top]]}

    return {"grad_norm_gap": leaves({k: grads[k] for k in ref_grads}, ref_grads, ref_grads),
            "change_gap": leaves({k: after[k] - init[k] for k in params},
                                 {k: last[k] - init[k] for k in params}, moving),
            "bn_stat_gap": leaves({k: after[k] - init[k] for k in buffers},
                                  {k: last[k] - init[k] for k in buffers}, buffers)}


def _steps_numbers(state, got, want):
    from bench_h100 import compare, train

    return train.numbers(state, [float(s["loss"]) for s in got], compare.to_cpu(got[0]["grads"]),
                         compare.to_cpu(got[-1]["state"]), want)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="",
                   help="the seeds of the control and the fault (default: --seeds)")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="chiprun_out/calibrate.jsonl")
    p.add_argument("--look", action="store_true",
                   help="training cells: the reference run again, and the leaves behind each "
                        "window number")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench_h100 import run

    run.use_checkout_caches()
    import torch

    from bench_h100 import manifest

    man = manifest.load(ROOT)
    cell = manifest.workload(man, args.workload)
    cfg, traffic = manifest.config(cell["config"]), manifest.traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        seeds = [int(s) for s in args.seeds.split(",") if s]
        control = [int(s) for s in (args.control_seeds or args.seeds).split(",") if s]
        for seed in dict.fromkeys(seeds + control):
            rows = []
            t = time.perf_counter()
            keep: dict = {}
            if seed in seeds or (seed in control and cfg["kind"] != "pipeline"):
                if cfg["kind"] == "pipeline":
                    r = run.run_cell(man, cell, seed, args.seconds, False, device, t)
                    nums = {k: v["value"] for k, v in r["checks"].items()}
                    rows.append({"reading": "program", "correct": r["correct"], "numbers": nums,
                                 "metrics": {k: v["value"] for k, v in r["metrics"].items()}})
                else:
                    from bench_h100 import compare, train

                    torch.backends.cuda.matmul.allow_tf32 = False
                    torch.backends.cudnn.allow_tf32 = False
                    o = train.run(cfg, traffic, seed, args.seconds, False, device, keep=keep)
                    ok, checks = compare.judge(o["numbers"], manifest.limits(cell["name"]))
                    rows.append({"reading": "program", "correct": ok, "numbers": o["numbers"],
                                 "metrics": o["e2e"], "window_step": keep["snap"]["step"]})
                    if args.look:
                        rows[-1]["look"] = look(cfg, seed, device, keep)
                        rows.append({"reading": "reference_again", "numbers": reference_again(
                            cfg, traffic, seed, device, keep)})
            if seed in control:
                w = window_numbers(cfg, traffic, seed, device, keep) if keep else {}
                rows.append({"reading": "control_tf32", "numbers": {
                    **control_numbers(cfg, traffic, seed, device), **w.get("control_tf32", {})}})
                if cfg["kind"] != "pipeline":
                    rows.append({"reading": "fault_half_batch", "numbers": {
                        **half_batch_numbers(cfg, traffic, seed, device),
                        **w["fault_half_batch"]}})
            for row in rows:
                row.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - t,
                           card=torch.cuda.get_device_name(device))
                line = json.dumps(row)
                print(line, flush=True)
                f.write(line + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
