"""Device-time helpers over ``torch.profiler``, the counterpart of
``gspn_tpu/utils/profiling.py``: a traced block (:func:`trace`), named
regions (:func:`annotate`), a rolling step timer (:class:`StepTimer`), a
run's device kernels and their busy time, and the trainers'
``--profile-steps`` window (:class:`StepTraceWindow`)."""

from __future__ import annotations

import contextlib
import json
import pathlib
import time

import torch

TOP_KERNELS = 10  # device kernels named in the window's JSON line, by time


@contextlib.contextmanager
def trace(log_dir: str | pathlib.Path):
    """Profile the block with ``torch.profiler`` (the host, and the card's
    kernels where CUDA is available) and write its Chrome trace to
    ``log_dir/trace.json`` (Perfetto or ``chrome://tracing`` read it).
    Yields the profiler, whose events a caller may read after the block."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def annotate(name: str):
    """A named region in the profiler's trace (``record_function``), as a
    context manager."""
    return torch.profiler.record_function(name)


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


def busy_us(events) -> float:
    """Union of device-kernel intervals (us), so overlap is counted once."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


class StepTraceWindow:
    """Profile ``count`` training steps from step index ``start``:
    ``tick(i)`` at the top of every step starts ``torch.profiler`` at
    ``start`` and stops it ``count`` steps later; ``close()`` stops it if
    training ends inside the window. On stopping it writes a Chrome trace
    to ``log_dir/trace.json`` and prints one JSON line: steps, wall ms per
    step (host clock, synchronized at both ends), device busy ms per step
    (the union of kernel intervals), the idle share, launches per step and
    the ``TOP_KERNELS`` device kernels' ms per step."""

    def __init__(self, log_dir, start: int, count: int, device):
        self.log_dir = pathlib.Path(log_dir)
        self.start = start
        self.count = count
        self.device = torch.device(device)
        self._prof = None
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
        prof.__exit__(None, None, None)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(self.log_dir / "trace.json"))
        kernels = device_kernels(prof)
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
            "trace": str(self.log_dir / "trace.json"),
        }), flush=True)
