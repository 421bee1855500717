"""The program's own spans and counters, as the per-layer readers
(``metrics/<name>.py``) read them after a run: ``span_stats()`` of
``gspn_tpu_torch.utils.profiling`` (each name's ``count``, ``total_s`` and
``mean_ms``, over the whole process) and ``launch_counts()`` of
``gspn_tpu_torch.ops._cuda``. They are read from the modules the run
loaded; this module imports nothing of the program. A program without
them, or a run that recorded nothing under a name, gives None."""

from __future__ import annotations

import sys

PROFILING = "gspn_tpu_torch.utils.profiling"
KERNELS = "gspn_tpu_torch.ops._cuda"


def _loaded(module: str, attr: str):
    return getattr(sys.modules.get(module), attr, None)


def stat(name: str) -> dict | None:
    """``span_stats()[name]`` where the program recorded it at least once."""
    read = _loaded(PROFILING, "span_stats")
    entry = read().get(name) if read is not None else None
    return entry if entry and entry["count"] > 0 else None


def per(ctx: dict, kind: str, name: str, over: str, scale: float = 1e3) -> float | None:
    """``name``'s total seconds over the count of ``over`` (the spans each
    call opens once), times ``scale`` (ms by default), in a ``kind`` run."""
    if ctx["kind"] != kind:
        return None
    part, calls = stat(name), stat(over)
    if part is None or calls is None:
        return None
    return scale * part["total_s"] / calls["count"]


def mean(ctx: dict, kind: str, name: str) -> float | None:
    """``name``'s mean ms a record, in a ``kind`` run."""
    if ctx["kind"] != kind:
        return None
    entry = stat(name)
    return None if entry is None else entry["mean_ms"]


def launches_per(ctx: dict, kind: str, over: str) -> float | None:
    """Launches of every hand-written kernel over the count of ``over``."""
    counts, calls = _loaded(KERNELS, "launch_counts"), stat(over)
    if ctx["kind"] != kind or counts is None or calls is None:
        return None
    return sum(counts().values()) / calls["count"]
