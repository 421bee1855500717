"""The arithmetic the per-layer metric readers (``metrics/<name>.py``)
share. Each takes the traced run's context: ``kind`` ("serve" or
"train"), ``call_s`` (seconds a request or step, untraced part),
``window`` (``trace.Window``), ``matmul_flops`` and ``point_least_s``
(``workcount``, a request or step) and, serving, ``host_ms``. A reader
that finds nothing to read returns None."""

from __future__ import annotations

from bench_h100 import workcount


def mfu(ctx: dict, kind: str):
    """The model's matrix FLOPs over what the float32 matmul peak does in
    the time a call takes, in %."""
    if ctx["kind"] != kind:
        return None
    return 100.0 * ctx["matmul_flops"] / (ctx["call_s"] * workcount.MATMUL_F32_FLOPS)


def device_ms(ctx: dict, kind: str, part: str):
    """Device ms a call in the profiled window's ``part`` ("gspn_s" or
    "library_s")."""
    win = ctx.get("window")
    if ctx["kind"] != kind or win is None or getattr(win, part) <= 0:
        return None
    return 1e3 * getattr(win, part) / win.calls


def kernel_roofline(ctx: dict, kind: str):
    """The point ops' least time over the hand-written kernels' device
    time, in %."""
    ms = device_ms(ctx, kind, "gspn_s")
    if ms is None:
        return None
    return 100.0 * ctx["point_least_s"] * 1e3 / ms


def idle_share(ctx: dict, kind: str):
    """Share of the profiled window with no device operation running, %."""
    win = ctx.get("window")
    if ctx["kind"] != kind or win is None or win.wall_s <= 0 or win.busy_s <= 0:
        return None
    return 100.0 * (1.0 - win.busy_s / win.wall_s)
