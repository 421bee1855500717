"""Device-time helpers over ``torch.profiler``, the counterpart of
``gspn_tpu/utils/profiling.py``: a traced block (:func:`trace`), named
regions (:func:`span`, and :func:`annotate`, its JAX-named alias), a
rolling step timer (:class:`StepTimer`), stream times of a step's phases
(:class:`StreamPhases`), a run's device kernels and their busy time, and
the trainers' ``--profile-steps`` window (:class:`StepTraceWindow`).

**Spans.** ``with span(name):`` times a region of host code. Two parts:

- *Counters, always on*: each name's count and total host nanoseconds
  (``time.perf_counter_ns``), kept by each thread in a table of its own
  and merged on read (:func:`span_stats`; :func:`reset_span_stats`). A
  span costs two clock reads and one accumulation: no lock, no record
  kept, and no ``record_function`` unless a profiler is running.
- *A timeline, while a recorder is on* (inside :func:`trace`,
  :class:`StepTraceWindow` or :func:`record_spans`): each span's name,
  start and end on ``perf_counter_ns``, thread, enclosing span and id
  (the id of the outermost span open on its thread, so the spans of one
  request or step share it). While ``torch.profiler`` runs, each span is
  also a ``record_function``, and a recorder starts by writing an anchor
  (a ``record_function`` named :data:`ANCHOR` beside a ``perf_counter_ns``
  reading), which maps every record, from any thread, onto the
  profiler's clock (:meth:`SpanRecorder.on_profiler_clock`).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import pathlib
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

TOP_KERNELS = 10  # device kernels named in the window's JSON line, by time
ANCHOR = "gspn.anchor"  # the record_function a SpanRecorder starts with
# an idle gap shorter than this is a launch boundary on the device; a
# longer one is labelled by the program's span open at its midpoint
SHORT_GAP_US = 10
STREAM_EVENT_SETS = 16  # the sets of events a StreamPhases makes once
# a timeline record: a span's name, start and end (perf_counter_ns), the
# thread's ident, the enclosing span's name (or None), the id of the
# outermost span open on its thread, and the spans enclosing it
RECORD_FIELDS = ("name", "start_ns", "end_ns", "thread", "parent", "id", "depth")

_TABLES: list[dict] = []  # each live thread's {name: [count, total ns]}, the retired first
_TABLES_LOCK = threading.RLock()
_RETIRED: dict[str, list] = {}  # the tables of threads that ended, folded together
_TABLES.append(_RETIRED)
_IDS = itertools.count(1)
_RECORDERS: list[SpanRecorder] = []  # the recorders that are on
_SPANS: dict[str, _Span] = {}


def _add(table: dict, name: str, ns: int) -> None:
    entry = table.get(name)
    if entry is None:
        entry = table[name] = [0, 0]
    entry[0] += 1
    entry[1] += ns


class _TableOwner:
    """Registers a thread's table, and folds it into the retired one when
    the thread ends (its thread-local state is dropped), so a server's
    short-lived handler threads neither lose their counts nor pile up
    tables."""

    __slots__ = ("table",)

    def __init__(self, table: dict):
        self.table = table
        with _TABLES_LOCK:
            _TABLES.append(table)

    def __del__(self):
        lock = _TABLES_LOCK
        if lock is None:  # interpreter shutdown
            return
        with lock:
            for name, (n, ns) in self.table.items():
                entry = _RETIRED.setdefault(name, [0, 0])
                entry[0] += n
                entry[1] += ns
            for i, t in enumerate(_TABLES):
                if t is self.table:
                    del _TABLES[i]
                    break


class _ThreadState(threading.local):
    """A thread's span table and its stack of open spans, each ``(name, id,
    record_function or None, start ns)``."""

    def __init__(self):
        self.table: dict[str, list] = {}
        self.stack: list[tuple] = []
        self.owner = _TableOwner(self.table)


_THREAD = _ThreadState()


class _Span:
    """The context manager of one span name, shared by every thread: what
    an open span holds lives on its thread's stack."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _THREAD.stack
        rf = None
        if _autograd_profiler._is_profiler_enabled:
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
        stack.append((self.name, stack[-1][1] if stack else next(_IDS), rf,
                      time.perf_counter_ns()))
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        state = _THREAD
        name, rid, rf, start = state.stack.pop()
        _add(state.table, name, end - start)
        if rf is not None:
            rf.__exit__(*exc)
        if _RECORDERS:
            stack = state.stack
            record = (name, start, end, threading.get_ident(), stack[-1][0] if stack else None,
                      rid, len(stack))
            for recorder in _RECORDERS:
                recorder.records.append(record)
        return False


def span(name: str) -> _Span:
    """A named region of host code, as a context manager: counted under
    ``name`` in :func:`span_stats`, recorded on the timeline while a
    recorder is on, and a ``record_function`` while ``torch.profiler``
    runs (module docstring)."""
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS.setdefault(name, _Span(name))
    return s


def span_stats() -> dict[str, dict]:
    """Every name's ``count``, ``total_s`` and ``mean_ms`` (a span), summed
    over every thread since the process started or since
    :func:`reset_span_stats`."""
    sums: dict[str, list] = {}
    with _TABLES_LOCK:
        for table in _TABLES:
            for name, (n, ns) in list(table.items()):
                entry = sums.setdefault(name, [0, 0])
                entry[0] += n
                entry[1] += ns
    return {name: {"count": n, "total_s": ns / 1e9, "mean_ms": ns / 1e6 / n if n else 0.0}
            for name, (n, ns) in sums.items()}


def reset_span_stats() -> None:
    """Zero every counter (meant between phases of a run, not while other
    threads are inside spans)."""
    with _TABLES_LOCK:
        for table in _TABLES:
            for entry in table.values():
                entry[0] = entry[1] = 0


def annotate(name: str) -> _Span:
    """A named region in the profiler's trace: :func:`span` under the JAX
    package's name."""
    return span(name)


class SpanRecorder:
    """The timeline of every span that ends, in any thread, while the
    recorder is on (:meth:`start` to :meth:`stop`): ``records``, tuples of
    :data:`RECORD_FIELDS`, kept in memory. :meth:`start` reads
    ``anchor_ns`` inside a ``record_function`` named :data:`ANCHOR`, which
    maps the records onto a profiler run that holds the anchor."""

    def __init__(self):
        self.records: list[tuple] = []
        self.anchor_ns: int | None = None

    def start(self) -> SpanRecorder:
        # a process's first record_function under a profiler spends ~1.5 ms
        # between its time stamp and its return: not in the anchor's
        with torch.profiler.record_function(f"{ANCHOR}.warm_up"):
            pass
        with torch.profiler.record_function(ANCHOR):
            self.anchor_ns = time.perf_counter_ns()
        _RECORDERS.append(self)
        return self

    def stop(self) -> None:
        with contextlib.suppress(ValueError):
            _RECORDERS.remove(self)

    def write(self, path: str | pathlib.Path) -> None:
        """The anchor and the records as JSON: a consumer finds the
        :data:`ANCHOR` event in the profiler's trace, and a record's time on
        the trace's clock is the anchor event's start plus the record's
        ``perf_counter_ns`` less ``anchor_ns``."""
        pathlib.Path(path).write_text(json.dumps({
            "anchor": ANCHOR, "anchor_ns": self.anchor_ns, "fields": list(RECORD_FIELDS),
            "records": [list(r) for r in self.records]}))

    def on_profiler_clock(self, events) -> list[tuple]:
        """The records as ``(name, start_us, end_us, depth)`` on the clock
        of a finished profiler run's ``events`` (``prof.events()``), through
        the anchor's event; empty where the run holds no anchor."""
        base = next((e.time_range.start for e in events
                     if e.name == ANCHOR and e.device_type == torch.autograd.DeviceType.CPU),
                    None)
        if base is None or self.anchor_ns is None:
            return []
        a = self.anchor_ns
        return [(r[0], base + (r[1] - a) / 1e3, base + (r[2] - a) / 1e3, r[6])
                for r in self.records]


@contextlib.contextmanager
def record_spans(path: str | pathlib.Path | None = None):
    """The timeline on for the block: yields the :class:`SpanRecorder`, and
    writes it to ``path`` at the end where given."""
    recorder = SpanRecorder().start()
    try:
        yield recorder
    finally:
        recorder.stop()
        if path is not None:
            recorder.write(path)


@contextlib.contextmanager
def trace(log_dir: str | pathlib.Path):
    """Profile the block with ``torch.profiler`` (the host, and the card's
    kernels where CUDA is available) and write its Chrome trace to
    ``log_dir/trace.json`` (Perfetto or ``chrome://tracing`` read it) and
    the program's spans to ``log_dir/spans.json``
    (:meth:`SpanRecorder.write`). Yields the profiler, whose events a
    caller may read after the block."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof, record_spans(log_dir / "spans.json"):
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


class StreamPhases:
    """Stream milliseconds of the named ``phases`` of a repeated piece of
    work, on the current CUDA stream, from one thread: :meth:`start`
    records an event at the work's start and :meth:`mark` ``(k)`` one at the
    end of phase ``k`` (1-based). A set of events is read only once its
    last event has completed (``query()``), at a later :meth:`start` or
    :meth:`poll`, never by waiting, and each phase's milliseconds are
    counted under ``"<phase>@stream"`` (:func:`span_stats`). The time
    includes the stream's idle inside the phase. The events come from a
    pool of :data:`STREAM_EVENT_SETS` sets made at the first start on a
    card; a start that finds every set pending records nothing, and off
    the card nothing is recorded."""

    def __init__(self, phases: tuple[str, ...]):
        self.names = tuple(f"{p}@stream" for p in phases)
        self._sets: list | None = None
        self._free: list[int] = []
        self._pending: collections.deque = collections.deque()
        self._open: int | None = None
        self._stream = None

    def start(self, device) -> None:
        if self._open is not None:  # the last piece of work raised before its end
            self._free.append(self._open)
            self._open = None
        device = torch.device(device)
        if device.type != "cuda":
            return
        if self._sets is None:
            n = len(self.names) + 1
            self._sets = [[torch.cuda.Event(enable_timing=True) for _ in range(n)]
                          for _ in range(STREAM_EVENT_SETS)]
            self._free = list(range(STREAM_EVENT_SETS))
        self.poll()
        if not self._free:
            return
        self._open = self._free.pop()
        self._stream = torch.cuda.current_stream(device)
        self._sets[self._open][0].record(self._stream)

    def mark(self, k: int) -> None:
        i = self._open
        if i is None:
            return
        self._sets[i][k].record(self._stream)
        if k == len(self.names):
            self._pending.append(i)
            self._open = None

    def poll(self) -> None:
        """Count the sets whose last event has completed, oldest first."""
        while self._pending:
            events = self._sets[self._pending[0]]
            if not events[-1].query():
                return
            self._free.append(self._pending.popleft())
            table = _THREAD.table
            for name, a, b in zip(self.names, events, events[1:]):
                _add(table, name, round(a.elapsed_time(b) * 1e6))


class StepTimer:
    """Rolling step times over the last ``window`` steps, and points a
    second at ``points_per_step``. On a CUDA ``device`` a step is timed by
    CUDA events recorded on the current stream at :meth:`start` and
    :meth:`stop` (``stop`` waits for the second), elsewhere by the host
    clock."""

    def __init__(self, points_per_step: int, window: int = 20, device=None):
        self.pps = points_per_step
        self.window = window
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self._times: list[float] = []
        self._t0 = None

    def start(self) -> None:
        if self.device.type == "cuda":
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record(torch.cuda.current_stream(self.device))
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        """The step's seconds since :meth:`start`, kept in the window."""
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            end.synchronize()
            dt = self._t0.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self._t0
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return dt

    @property
    def mean_step_s(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    @property
    def points_per_sec(self) -> float:
        m = self.mean_step_s
        return self.pps / m if m > 0 else 0.0


def device_kernels(prof) -> list:
    """A finished ``torch.profiler`` run's device kernels: its CUDA events
    without the user annotations the profiler mirrors onto the device
    timeline (``Optimizer.step#Adam.step`` spans a whole optimizer step,
    gaps included)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]


def _union(intervals) -> list[list]:
    """Overlapping or touching ``(start, end)`` intervals merged, in order."""
    out: list[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(events) -> float:
    """Union of device-kernel intervals (us), so overlap is counted once."""
    return sum(e - s for s, e in _union((e.time_range.start, e.time_range.end)
                                        for e in events))


def idle_gaps(kernels, spans) -> list:
    """The idle gaps between device ``kernels`` (``(start, end)`` us), each
    of :data:`SHORT_GAP_US` or longer labelled by the innermost of
    ``spans`` (``(name, start, end, depth)`` on the same clock, from any
    thread) open at its midpoint, or "no span": ``[["<label> (<n> gaps)",
    seconds], ...]``, most seconds first, at most :data:`TOP_KERNELS`
    (the form of the benchmark's ``breakdown.idle_gaps``)."""
    busy = _union(kernels)
    by_label: dict[str, list] = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        if b - a < SHORT_GAP_US:
            continue
        mid, best = (a + b) / 2, None
        for name, s, e, depth in spans:
            if s <= mid <= e and (best is None or (depth, s) > best[1:]):
                best = (name, depth, s)
        entry = by_label.setdefault(best[0] if best else "no span", [0, 0.0])
        entry[0] += 1
        entry[1] += (b - a) / 1e6
    gaps = sorted(([f"{k} ({n} gaps)", sec] for k, (n, sec) in by_label.items()),
                  key=lambda g: -g[1])
    return gaps[:TOP_KERNELS]


class StepTraceWindow:
    """Profile ``count`` training steps from step index ``start``:
    ``tick(i)`` at the top of every step starts ``torch.profiler`` at
    ``start`` and stops it ``count`` steps later; ``close()`` stops it if
    training ends inside the window. A :class:`SpanRecorder` is on while
    the profiler runs. On stopping it writes a Chrome trace to
    ``log_dir/trace.json`` and the program's spans to
    ``log_dir/spans.json``, and prints one JSON line: steps, wall ms per
    step (host clock, synchronized at both ends), device busy ms per step
    (the union of kernel intervals), the idle share, launches per step,
    the ``TOP_KERNELS`` device kernels' ms per step and ``idle_gaps``, the
    gaps between kernels of ``SHORT_GAP_US`` or longer by the innermost
    program span open at each one's midpoint (:func:`idle_gaps`)."""

    def __init__(self, log_dir, start: int, count: int, device):
        self.log_dir = pathlib.Path(log_dir)
        self.start = start
        self.count = count
        self.device = torch.device(device)
        self._prof = None
        self._recorder: SpanRecorder | None = None
        self._t0 = 0.0
        self._steps = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tick(self, i: int) -> None:
        if self.count <= 0:
            return
        if self._prof is None and i == self.start:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._sync()
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._recorder = SpanRecorder().start()
            self._t0 = time.perf_counter()
            self._steps = 0
        elif self._prof is not None and i >= self.start + self.count:
            self.close()
        if self._prof is not None:
            self._steps += 1

    def close(self) -> None:
        if self._prof is None:
            return
        self._sync()
        wall_ms = (time.perf_counter() - self._t0) * 1e3
        prof, self._prof = self._prof, None
        recorder, self._recorder = self._recorder, None
        recorder.stop()
        prof.__exit__(None, None, None)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(self.log_dir / "trace.json"))
        recorder.write(self.log_dir / "spans.json")
        kernels = device_kernels(prof)
        gaps = idle_gaps([(e.time_range.start, e.time_range.end) for e in kernels],
                         recorder.on_profiler_clock(prof.events()))
        steps = max(self._steps, 1)
        busy_ms = busy_us(kernels) / 1e3 / steps
        by_name: dict[str, float] = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
        print(json.dumps({
            "profiled_steps": self._steps, "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (wall_ms / steps) if kernels else None,
            "device_launches_per_step": len(kernels) / steps,
            "top_kernels_ms_per_step": dict(top),
            "idle_gaps": gaps,
            "trace": str(self.log_dir / "trace.json"),
        }), flush=True)
