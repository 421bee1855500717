"""Kernel debugging aids, the counterpart of ``gspn_tpu/utils/debug.py``:
the plain versions in place of the kernels (:func:`plain_kernels`, for
Pallas's interpret mode), a check of a function's floating outputs
(:func:`checked`, for checkify's float checks), and a runner that
launches every hand-written kernel once on each of its code paths, for
NVIDIA's compute-sanitizer to watch.

    python -m gspn_tpu_torch.utils.debug --sanitize
    python -m gspn_tpu_torch.utils.debug --under memcheck,racecheck,synccheck,initcheck

``--sanitize`` runs the launches (:func:`sanitize_cases`: every launch of
``time_kernels.cases`` at its own shape, every plan the kernels' launchers
can be forced to, and a few small cases for the paths no slice takes,
each output held bitwise against its plain version) in this process;
``--under TOOLS`` runs ``--sanitize`` under ``compute-sanitizer --tool
T --error-exitcode 1`` for each tool, all at once, checking only the
port's kernels (their names carry ``gspn``), and fails on any report.
Both need a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import torch

SANITIZER_TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
# the port's kernels are gspn::...: their mangled names hold "gspn", and no
# PyTorch or library kernel's does
SANITIZER_FILTER = ("--kernel-name", "kns=gspn")
# tools that read allocations: the caching allocator's slack would hide a
# read past a tensor's end, and its reuse an uninitialized read
UNCACHED_TOOLS = ("memcheck", "initcheck")
SANITIZE_DONE = "sanitize: done"
_SUMMARY = re.compile(r"SUMMARY: (\d+) (?:errors|hazards)")


@contextlib.contextmanager
def plain_kernels():
    """Within the block every op called with ``impl="auto"`` runs its plain
    PyTorch version, on the card too (``ops.common.resolve_impl``); an
    explicit ``impl="cuda"`` still launches its kernel. The switch is
    process-wide, as Pallas's interpret mode is, so that a backward pass
    on autograd's own thread sees it too. A debugging aid: nothing on the
    main path enters it."""
    from gspn_tpu_torch.ops import common

    before = common.AUTO_PLAIN
    common.AUTO_PLAIN = True
    try:
        yield
    finally:
        common.AUTO_PLAIN = before


@dataclasses.dataclass
class FloatError:
    """What :func:`checked` found: ``None``, or where the first non-finite
    floating output is."""

    message: str | None = None

    def get(self) -> str | None:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def _first_nonfinite(tree, path: str) -> str | None:
    if isinstance(tree, torch.Tensor):
        if (tree.is_floating_point() or tree.is_complex()) and not torch.isfinite(tree).all():
            return f"output{path}: {int((~torch.isfinite(tree)).sum())} NaN or inf values"
        return None
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))
    else:
        return None
    for k, v in items:
        found = _first_nonfinite(v, f"{path}[{k!r}]")
        if found:
            return found
    return None


def checked(fn):
    """``fn`` wrapped to return ``(error, out)``: ``error.throw()`` raises
    ``FloatingPointError`` when a floating tensor of ``out`` (a tensor, or
    dicts, lists, tuples and dataclasses of them) holds a NaN or an inf."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        return FloatError(_first_nonfinite(out, "")), out

    return wrapped


# ---------------------------------------------------------------------------
# The launches a sanitizer watches
# ---------------------------------------------------------------------------


def extra_cases(ops, dev) -> list[tuple[str, str, object, tuple]]:
    """``[(kernel, label, entry point or None, args)]``: the code paths that
    no launch of ``time_kernels.cases`` takes, at small shapes (``None``:
    ``time_kernels.call``'s entry point, in ``cases``' layout): fps_cluster
    on rows of 14,273 points (one row all invalid), which 2 and 4 CTAs
    hold; the ball group and query at two scales; three_nn with validity;
    interp_mm from weights (``three_interpolate_mm``); NMS above 1024 boxes
    (ranked before the kernel); nn_argmin both ways with a row's targets
    over 17 tiles (each count of CTAs a row, 16 taking two passes), and
    one way; the training BatchNorm's four kernels (masked, with the
    ReLU) and its odd-width path (C 37, one channel a thread)."""
    from gspn_tpu_torch.ops.fps import FPS_MAX_N

    gen = torch.Generator().manual_seed(0)

    def scene(b, n, pad=0.1, extent=2.0):
        xyz = torch.rand((b, n, 3), generator=gen) * extent
        valid = torch.ones((b, n), dtype=torch.bool)
        valid[:, n - int(n * pad):] = False
        return xyz.to(dev), valid.to(dev)

    def boxes_about(centres, lo, hi):
        half = (torch.rand(centres.shape, generator=gen) * (hi - lo) + lo).to(dev)
        return torch.cat([centres - half, centres + half], dim=-1)

    xyz, valid = scene(2, FPS_MAX_N + 1)
    valid[1] = False
    pts, pvalid = scene(2, 2048)
    scales = ((0.2, 0.4), (8, 16), pts, pts[:, ::32].contiguous(), pvalid)
    tgt, _ = scene(2, 300)
    src, svalid = scene(2, 700)
    dist, idx = ops.three_nn(tgt, src, svalid, impl="plain")
    feats = torch.randn((2, 700, 64), generator=gen).to(dev)
    nms_boxes = boxes_about(scene(1, 1100, pad=0.0, extent=3.0)[0], 0.1, 0.6)
    nms_scores = torch.rand((1, 1100), generator=gen).to(dev)
    a, av = scene(2, 4100)
    bb, bv = scene(2, 500)
    part = functools.partial
    bn = []
    for c, label in ((64, "3000 x 64, masked, ReLU"), (37, "3000 x 37 (odd width), masked, ReLU")):
        x = (torch.randn((3000, c), generator=gen) + 1.0).to(dev)
        g = torch.randn((3000, c), generator=gen).to(dev)
        mask = (torch.rand(3000, generator=gen) > 0.3).to(dev)
        scale = (torch.rand(c, generator=gen) + 0.5).to(dev)
        bias = torch.randn(c, generator=gen).to(dev)
        running = (torch.zeros(c, device=dev), torch.ones(c, device=dev))
        stats = ops.batch_norm_stats(x, mask, *running, eps=1e-3, momentum=0.9, update=False,
                                     impl="plain")
        _, _, tr, td = ops.batch_norm_grad_terms(x, g, stats, scale, bias, relu=True,
                                                 impl="plain")
        bn += [
            ("bn_stats", label, part(ops.batch_norm_stats, eps=1e-3, momentum=0.9, update=False),
             (x, mask, *running)),
            ("bn_apply", label, part(ops.batch_norm_apply, relu=True), (x, stats, scale, bias)),
            ("bn_grad_terms", label, part(ops.batch_norm_grad_terms, relu=True),
             (x, g, stats, scale, bias)),
            ("bn_grad_input", label, ops.batch_norm_grad_input,
             (x, td, mask, stats, tr.sum(dim=0), td.sum(dim=0))),
        ]
    return bn + [
        ("fps_cluster", f"2 x {FPS_MAX_N + 1} pts (a row all invalid), 32 picks", None,
         (32, xyz, valid)),
        ("ball_group", "Ball<2>: 2 x 64 q over 2048, r .2/.4, K 8/16", None, scales),
        ("ball_query", "Ball<2>: 2 x 64 q over 2048, r .2/.4, K 8/16", None, scales),
        ("three_nn", "2 x 300 <- 700, sources masked", None, (tgt, src, svalid)),
        ("interp_mm", "from weights: 2 x 300 <- 700, C 64", ops.three_interpolate_mm,
         (feats, idx, ops.three_interpolate_weights(dist))),
        ("nms", "1 x 1100 boxes, IoU 0.25", None, (nms_boxes, nms_scores, 0.25)),
        ("nn_argmin", "2 rows x 4100 <-> 500 both ways, both masked", None, (a, bb, av, bv)),
        ("nn_argmin", "one way: 2 rows x 4100 <- 500, masked", ops.nn_argmin, (a, bb, bv)),
    ]


def sanitize_cases(ops, dev, cases=None) -> list[tuple[str, str, object, object]]:
    """``[(kernel, path, launch, plain)]``: ``launch()`` launches kernel
    ``kernel`` once, ``plain()`` computes the same on its plain version.
    Every case of ``cases`` (``time_kernels.cases``' layout; by default
    ``time_kernels.cases`` itself: every launch of the ranked slices and of
    slice (R), at its own shape) and of :func:`extra_cases` through its
    entry point; then, on each kernel's first case and on each extra case,
    every plan of ``time_kernels.forced_plans`` (cluster sizes, splits,
    strided plans, three_nn and interp_mm plans, CTAs a row)."""
    from gspn_tpu_torch.utils import bench_slice
    from gspn_tpu_torch.utils import time_kernels as tk

    part = functools.partial
    if cases is None:
        cases = tk.cases(ops, bench_slice, dev)
    planned = [(name, items[0][0], None, items[0][1]) for name, items in cases.items() if items]
    extras = extra_cases(ops, dev)
    out = [(name, label, part(tk.call, ops, name, args, "cuda"),
            part(tk.call, ops, name, args, "plain"))
           for name, items in cases.items() for label, args, _ in items]
    for name, label, fn, args in extras:
        if fn is None:
            out.append((name, label, part(tk.call, ops, name, args, "cuda"),
                        part(tk.call, ops, name, args, "plain")))
        else:
            out.append((name, label, part(fn, *args, impl="cuda"),
                        part(fn, *args, impl="plain")))
    for name, label, fn, args in planned + [e for e in extras if e[2] is None]:
        for plan, run in tk.forced_plans(name, args).items():
            out.append((name, f"{label}, plan {plan}", run,
                        part(tk.call, ops, name, args, "plain")))
    return out


def run_sanitize_cases() -> dict[str, int]:
    """Launch every case of :func:`sanitize_cases` once on the card, each
    held bitwise against its plain version; print a line a case and
    :data:`SANITIZE_DONE`; return the launches by kernel. Every kernel of
    ``ops.KERNELS`` must launch."""
    from gspn_tpu_torch import ops
    from gspn_tpu_torch.ops import _cuda
    from gspn_tpu_torch.utils import time_kernels as tk

    if not torch.cuda.is_available():
        raise SystemExit("debug --sanitize: needs a CUDA device")
    _cuda.library()
    dev = torch.device("cuda", 0)
    cases = sanitize_cases(ops, dev)
    ops.reset_launch_counts()
    for kernel, path, launch, plain in cases:
        before = ops.KERNELS[kernel].launches
        got = tk.flatten(launch())
        torch.cuda.synchronize()
        if ops.KERNELS[kernel].launches != before + 1:
            raise AssertionError(f"{kernel} [{path}]: launched "
                                 f"{ops.KERNELS[kernel].launches - before} times, not once")
        tk.max_abs_err(got, tk.flatten(plain()))
        print(f"sanitize {kernel} [{path}]: launched, bitwise its plain version", flush=True)
    counts = {k: c for k, c in ops.launch_counts().items()}
    missing = sorted(k for k, c in counts.items() if not c)
    if missing:
        raise AssertionError(f"kernels never launched: {missing}")
    print(f"{SANITIZE_DONE}: {len(cases)} launches of {len(counts)} kernels", flush=True)
    return counts


def sanitizer_path() -> str | None:
    """``compute-sanitizer`` from PATH or the CUDA toolkit, or None."""
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "compute-sanitizer")
    return path if os.path.exists(path) else None


def sanitizer_command(tool: str, argv: list[str]) -> tuple[list[str], dict]:
    """``(command, environment)`` that runs ``argv`` under ``tool``,
    checking only the port's kernels; any report exits 1."""
    cmd = [sanitizer_path(), "--tool", tool, "--error-exitcode", "1", *SANITIZER_FILTER]
    env = dict(os.environ)
    if tool in UNCACHED_TOOLS:
        env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
    return cmd + argv, env


def _tool_clean(rc: int, output: str) -> bool:
    """Exit 0, and a tool summary, each at 0 errors or hazards."""
    summaries = _SUMMARY.findall(output)
    return rc == 0 and bool(summaries) and all(n == "0" for n in summaries)


def sanitizer_clean(rc: int, output: str) -> bool:
    """Whether a sanitized ``--sanitize`` run passed: every case run, and
    the tool clean."""
    return SANITIZE_DONE in output and _tool_clean(rc, output)


# a program that runs no kernel of the port: what a sanitizer that can check
# this card passes
PROBE = "import torch; x = torch.ones(1024, device='cuda'); print(float(x.sum()))"
# compute-sanitizer's answer where the machine keeps the card from it
UNSUPPORTED = "Device not supported"


def sanitizer_usable(timeout: float = 300.0) -> tuple[bool, str]:
    """``(True, "")`` where compute-sanitizer's memcheck passes
    :data:`PROBE`; ``(False, its error line)`` where it answers
    :data:`UNSUPPORTED`. Any other failure of the probe raises
    ``AssertionError``."""
    cmd, env = sanitizer_command("memcheck", [sys.executable, "-c", PROBE])
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout)
    text = res.stdout + res.stderr
    if _tool_clean(res.returncode, text):
        return True, ""
    unsupported = [ln.strip("= ").strip() for ln in text.splitlines() if UNSUPPORTED in ln]
    if unsupported:
        return False, unsupported[0]
    raise AssertionError(f"compute-sanitizer's probe failed (exit {res.returncode}): "
                         f"{text.strip()[-2000:]}")


def run_under(tools, timeout: float = 600.0) -> dict[str, dict]:
    """Run ``--sanitize`` under each of ``tools`` at once, one process each;
    ``{tool: {"ok", "rc", "seconds", "summary", "output"}}``."""
    if sanitizer_path() is None:
        raise SystemExit("compute-sanitizer not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    argv = [sys.executable, "-m", "gspn_tpu_torch.utils.debug", "--sanitize"]
    repo = str(pathlib.Path(__file__).resolve().parents[2])
    procs, t0 = {}, time.perf_counter()
    for tool in tools:
        cmd, env = sanitizer_command(tool, argv)
        env["PYTHONPATH"] = os.pathsep.join(filter(None, (repo, env.get("PYTHONPATH"))))
        procs[tool] = subprocess.Popen(cmd, env=env, cwd=repo, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    out = {}
    for tool, proc in procs.items():
        try:
            text, _ = proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            text += f"\n(killed after {timeout:.0f} s)"
        out[tool] = {"ok": sanitizer_clean(proc.returncode, text), "rc": proc.returncode,
                     "seconds": time.perf_counter() - t0,
                     "summary": [ln.strip() for ln in text.splitlines() if "SUMMARY" in ln],
                     "output": text}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sanitize", action="store_true",
                    help="launch every kernel once on each code path, against its plain version")
    ap.add_argument("--under", default=None,
                    help=f"run --sanitize under these compute-sanitizer tools, comma-separated "
                         f"({','.join(SANITIZER_TOOLS)})")
    args = ap.parse_args(argv)
    if args.sanitize:
        run_sanitize_cases()
    if args.under:
        usable, why = sanitizer_usable()
        if not usable:
            raise SystemExit(f"compute-sanitizer cannot check this card: {why}")
        failed = []
        for tool, r in run_under(args.under.split(",")).items():
            print(f"compute-sanitizer --tool {tool}: {'clean' if r['ok'] else 'FAILED'} "
                  f"(exit {r['rc']}, {r['seconds']:.1f} s) {r['summary']}", flush=True)
            if not r["ok"]:
                failed.append(tool)
                print(r["output"][-20000:])
        if failed:
            raise SystemExit(f"compute-sanitizer reported under {failed}")
    if not (args.sanitize or args.under):
        ap.error("give --sanitize or --under")


if __name__ == "__main__":
    main()
