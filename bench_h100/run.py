"""Run one cell of the port's benchmark once, on the machine it starts on:

    python bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number of the correctness comparison beside its limit (also the last
lines of standard error). Without a CUDA device, or with fewer than the
cell asks for, it exits with 2 and prints no result; if JAX or the JAX
package was loaded, with 3; if every profiler window of a ``--trace 1``
run lost records, with 4.
"""

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout (the
# program's own kernel library builds into gspn_tpu_torch/_build/)
CACHE = ROOT / ".bench_h100_cache"
CACHE_VARS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TORCHINDUCTOR_CACHE_DIR": "inductor", "PYTORCH_KERNEL_CACHE_PATH": "kernels"}
FORBIDDEN = ("jax", "jaxlib", "flax", "gspn_tpu")


class IncompleteTrace(RuntimeError):
    """Every profiler window of a traced run lost device records: its busy
    time, idle share and device ms would read low."""


def use_checkout_caches() -> None:
    """Point every build and kernel cache at its fixed directory in the
    checkout (before torch is imported)."""
    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(CACHE / sub)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def run_cell(man: dict, cell: dict, seed: int, seconds: float, traced: bool, device,
             clock0: float, base=None) -> dict:
    """One run of ``cell``: the result line as a dict."""
    import torch

    from bench_h100 import compare, manifest, serve, train

    base = base or manifest.HERE
    print(f"process start to the cell's set-up: {time.perf_counter() - clock0:.3f} s",
          file=sys.stderr)
    cfg = manifest.config(cell["config"], base)
    traffic = manifest.traffic(cell["traffic"], base)
    # the configurations state float32 with TF32 off, for both sides
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = serve if cfg["kind"] == "pipeline" else train
    out = driver.run(cfg, traffic, seed, seconds, traced, device)
    ok, checks = compare.judge(out["numbers"], manifest.limits(cell["name"], base))
    metrics = {}
    if not traced:
        values = dict(out["e2e"], setup_s=out["setup_end"] - clock0)
        for m in manifest.end_to_end(man, cell["name"]):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = out["layer"]
        for m in manifest.per_layer(man, cell["name"]):
            value = manifest.metric_reader(m["name"], base)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": ok and out["failed"] == 0, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if traced:
        win = out["layer"]["window"]
        if not win.complete:
            raise IncompleteTrace("the profiler lost device records in every window taken")
        dev.update(busy_s=win.busy_s, window_s=win.wall_s)
        result["breakdown"] = {"device_ops": win.top, "idle_gaps": win.gaps}
    result["checks"] = checks
    parts = ", ".join(f"{k} {v:.3f} s" for k, v in out["setup_parts"].items())
    print(f"set-up after the imports: {parts}", file=sys.stderr)
    print(out["checked"], file=sys.stderr)
    return result


def emit(result: dict) -> None:
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    use_checkout_caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_h100 import manifest

    man = manifest.load(ROOT)
    cell = manifest.workload(man, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        result = run_cell(man, cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), CLOCK0)
    except IncompleteTrace as e:
        print(e, file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
