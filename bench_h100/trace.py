"""The traced part of a ``--trace 1`` run: host spans the benchmark's own
files open around its calls into the program, and one ``torch.profiler``
window over a few steady requests or steps, read into device busy time,
device time by kernel class, the top device operations and the idle gaps
labelled by the host span that was open.

The busy arithmetic (the union of device intervals) and the check that a
window kept every record (a closing spin kernel of its own is its last
event) are copied from ``gspn_tpu_torch/utils/profiling.py`` and
``utils/time_kernels.py``; CUPTI loses records now and then, so an
incomplete window is taken again, up to ``WINDOWS`` times; a run whose
windows all lost records reports no number of the trace (``run.py``
exits without a result).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

SPIN_CYCLES = 200_000
SPIN_NAME = "spin_kernel"  # torch.cuda._sleep's kernel
WINDOWS = 5
GSPN_PREFIX = "gspn::"
TOP = 10
ANCHOR = "bench_h100.anchor"
# an idle gap shorter than this is a launch boundary on the device (a
# graph's or a queue's); a longer one is labelled by the host span open
SHORT_GAP_US = 10


@dataclasses.dataclass
class Window:
    """One complete profiler window over ``calls`` requests or steps."""

    calls: int
    wall_s: float  # from the opening spin's end to the closing spin's start
    busy_s: float
    gspn_s: float  # kernels of the hand-written library (namespace gspn)
    library_s: float  # every other kernel (memcpy and memset aside)
    top: list  # [[name, seconds]] of the device operations, most time first
    gaps: list  # [[label, seconds]] the idle gaps' seconds by the host span open
    complete: bool


class Spans:
    """Host spans the benchmark's own files open around their calls into the
    program, from any thread: ``(name, start, end)`` on
    ``time.perf_counter`` (the profiler records only the thread that
    started it)."""

    def __init__(self):
        self.items: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t, time.perf_counter()))


def _is_copy(name: str) -> bool:
    n = name.lower()
    return n.startswith("memcpy") or n.startswith("memset")


def _union(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(fn, calls: int, spans: Spans, names: tuple[str, ...],
            units: int | None = None) -> Window:
    """Run ``fn()`` ``calls`` times under ``torch.profiler`` between two spin
    kernels; retake the window (up to ``WINDOWS`` times) unless its last
    device event is the closing spin. ``spans`` records the host spans that
    label idle gaps, ``names`` innermost first; time under none is the
    harness's. ``units``: the requests or steps the window holds (default
    ``calls``)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for attempt in range(WINDOWS):
        torch.cuda.synchronize()
        spans.items.clear()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(ANCHOR):
                anchor = time.perf_counter()
            torch.cuda._sleep(SPIN_CYCLES)
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        events = list(prof.events())
        dev = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.is_user_annotation), key=lambda e: e.time_range.start)
        complete = bool(dev) and SPIN_NAME in dev[-1].name and sum(
            SPIN_NAME in e.name for e in dev) >= 2
        if complete or attempt == WINDOWS - 1:
            break
    work = [e for e in dev if SPIN_NAME not in e.name]
    spins = [e for e in dev if SPIN_NAME in e.name]
    lo = spins[0].time_range.end if len(spins) >= 2 else (work[0].time_range.start if work else 0)
    hi = spins[-1].time_range.start if len(spins) >= 2 else (work[-1].time_range.end if work else 0)
    busy_iv = _union([(e.time_range.start, e.time_range.end) for e in work])
    busy = sum(e - s for s, e in busy_iv) / 1e6
    by_name: dict[str, float] = {}
    gspn = lib = 0.0
    for e in work:
        d = (e.time_range.end - e.time_range.start) / 1e6
        by_name[e.name] = by_name.get(e.name, 0.0) + d
        if GSPN_PREFIX in e.name:
            gspn += d
        elif not _is_copy(e.name):
            lib += d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    base = next((e.time_range.start for e in events
                 if e.name == ANCHOR and e.device_type == torch.autograd.DeviceType.CPU), None)
    host = [] if base is None else [
        (n, base + (a - anchor) * 1e6, base + (b - anchor) * 1e6) for n, a, b in spans.items]
    gaps: dict[str, list] = {}
    edges = [lo] + [x for iv in busy_iv for x in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        label = "harness"
        if e - s < SHORT_GAP_US:
            label = f"between kernels (< {SHORT_GAP_US} us)"
        else:
            for name in names:
                if any(n == name and a <= mid <= b for n, a, b in host):
                    label = name
                    break
        g = gaps.setdefault(label, [0, 0.0])
        g[0] += 1
        g[1] += (e - s) / 1e6
    gap_list = sorted(([f"{k} ({n} gaps)", s] for k, (n, s) in gaps.items()), key=lambda x: -x[1])
    return Window(calls=units or calls, wall_s=(hi - lo) / 1e6 if hi > lo else wall,
                  busy_s=busy, gspn_s=gspn, library_s=lib,
                  top=[[k, v] for k, v in top], gaps=gap_list[:TOP], complete=complete)
