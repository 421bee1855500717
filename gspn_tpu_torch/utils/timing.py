"""Seconds a call takes, waited for on the card: the counterpart of
``gspn_tpu/utils/timing.py``. PyTorch returns before the card finishes
the work it queued, so every time here ends in :func:`sync`."""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch

STATS = {"mean": statistics.fmean, "median": statistics.median, "min": min}


def _cuda_devices(tree, found: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), found)
    return found


def sync(tree) -> None:
    """Wait until the card has finished the work that produces ``tree`` (a
    tensor, or dicts, lists, tuples and dataclasses of them): a
    ``torch.cuda.synchronize`` of each device its CUDA tensors lie on. A
    tree of CPU tensors has nothing to wait on."""
    for device in _cuda_devices(tree, set()):
        torch.cuda.synchronize(device)


def time_fn(
    fn,
    *args,
    iters: int = 10,
    warmup: int = 2,
    batches: int = 1,
    stat: str = "mean",
) -> float:
    """Seconds a call of ``fn(*args)``, on the host clock, synchronized at
    completion: ``warmup`` calls, then ``batches`` blocks of ``iters``
    calls, each block's mean aggregated with ``stat`` ("mean" | "median"
    | "min"). The host clock of a machine shared with other work drifts
    between blocks; the median of blocks keeps one slow block from setting
    the figure."""
    if stat not in STATS:
        raise ValueError(f"stat must be mean|median|min, got {stat!r}")
    for _ in range(warmup):
        sync(fn(*args))
    means = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        sync(out)
        means.append((time.perf_counter() - t0) / iters)
    return float(STATS[stat](means))
