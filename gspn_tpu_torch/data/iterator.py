"""Deterministic, resumable data iteration: the PyTorch counterpart of
``gspn_tpu/data/iterator.py``. Batch ``i`` is a pure function of ``(seed,
i)``, so restoring a checkpoint at step ``s`` and continuing from batch
``s`` reproduces the uninterrupted run."""

from __future__ import annotations

import collections

import numpy as np
import torch


class DeterministicBatches:
    """Wraps any ``sample_fn(np_rng, batch_size) -> batch dict``; batch i
    is generated from an rng seeded by ``(seed, i)`` only (the same
    ``SeedSequence`` as the JAX package, so the arrays are equal)."""

    def __init__(self, sample_fn, batch_size: int, seed: int = 0):
        self.sample_fn = sample_fn
        self.batch_size = batch_size
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence(entropy=self.seed, spawn_key=(step,)))
        return self.sample_fn(rng, self.batch_size)


def to_device(batch: dict, device) -> dict:
    """A host batch's arrays as tensors on ``device`` (host-only metadata,
    ``scene_ids``, stays behind)."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()
            if k != "scene_ids"}


def make_feed(batches: DeterministicBatches, start_step: int, stop_step: int, prefetch: int,
              device):
    """Yield ``(step, batch on device)`` for ``start_step <= step <
    stop_step``, the same batches in the same order whatever ``prefetch``.

    On a CUDA device with ``prefetch > 0``, up to ``prefetch`` batches are
    staged ahead of the one yielded: generated on the host, pinned, and
    copied with ``non_blocking`` on a side stream, so the copies overlap
    the running steps; the consumer's stream waits for each copy before
    the batch is yielded. Elsewhere each batch is staged when it is
    needed."""
    device = torch.device(device)
    if device.type != "cuda" or prefetch <= 0:
        for i in range(start_step, stop_step):
            yield i, to_device(batches.batch_at(i), device)
        return
    side = torch.cuda.Stream(device)
    main = torch.cuda.current_stream(device)

    def stage(i):
        host = {k: torch.from_numpy(np.asarray(v))
                for k, v in batches.batch_at(i).items() if k != "scene_ids"}
        host = {k: t.pin_memory() if t.numel() else t for k, t in host.items()}
        with torch.cuda.stream(side):
            staged = {k: t.to(device, non_blocking=True) for k, t in host.items()}
            copied = torch.cuda.Event()
            copied.record(side)
        return i, staged, copied

    pending = collections.deque()
    nxt = start_step
    while nxt < stop_step and len(pending) < prefetch:
        pending.append(stage(nxt))
        nxt += 1
    while pending:
        i, staged, copied = pending.popleft()
        main.wait_event(copied)
        for t in staged.values():
            t.record_stream(main)  # allocated on the side stream, used on main
        if nxt < stop_step:
            pending.append(stage(nxt))
            nxt += 1
        yield i, staged
