"""The benchmark's traffic generator: synthetic ScanNet-style rooms (floor
clutter plus 2 to ``max_instances`` box, sphere and cylinder surfaces,
shuffled), and the pools of requests or batches a traffic file asks for.

The room generator is a frozen copy of ``gspn_tpu_torch/data/synthetic.py``
(``scene``'s default "count" density and "floor" background), so a later
change to the program's data code leaves the yardstick as it is. A pool
is made from the run's seed: every seed gives the same shapes, the same
number of scenes and the same share of invalid points, with other rooms.
"""

from __future__ import annotations

import numpy as np
import torch

_KINDS = ["box", "sphere", "cylinder"]


def _object(rng: np.random.Generator, n: int):
    kind = rng.choice(_KINDS)
    if kind == "sphere":
        v = rng.standard_normal((n, 3))
        pts = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9) * 0.5
    elif kind == "cylinder":
        theta = rng.uniform(0, 2 * np.pi, n)
        z = rng.uniform(-0.5, 0.5, n)
        pts = np.stack([0.3 * np.cos(theta), 0.3 * np.sin(theta), z], 1)
    else:
        face = rng.integers(0, 6, n)
        uv = rng.uniform(-0.5, 0.5, (n, 2))
        pts = np.zeros((n, 3))
        axis = face // 2
        sign = np.where(face % 2 == 0, -0.5, 0.5)
        for a in range(3):
            sel = axis == a
            others = [i for i in range(3) if i != a]
            pts[sel, a] = sign[sel]
            pts[sel, others[0]] = uv[sel, 0]
            pts[sel, others[1]] = uv[sel, 1]
    scale = rng.uniform(0.7, 1.3, (1, 3))
    return (pts * scale).astype(np.float32), kind


def room(rng: np.random.Generator, n_points: int, max_instances: int = 8, extent: float = 4.0,
         bg_frac: float = 0.3, size_range=(0.3, 0.8)) -> dict:
    """One room of ``n_points``: 30 % floor clutter, the rest shared equally
    by its instances; the remainder of the division is invalid padding.
    Labels: semantic 1 + shape kind, instance 1..I (0 background)."""
    n_inst = int(rng.integers(2, max_instances + 1))
    n_bg = int(n_points * bg_frac)
    count = (n_points - n_bg) // n_inst
    bg = rng.uniform(0, extent, (n_bg, 3)).astype(np.float32)
    bg[:, 2] = np.abs(rng.standard_normal(n_bg).astype(np.float32)) * 0.02
    xyz, sem, inst = [bg], [np.zeros(n_bg, np.int32)], [np.zeros(n_bg, np.int32)]
    for i in range(n_inst):
        pts, kind = _object(rng, count)
        size = rng.uniform(size_range[0], size_range[1])
        loc = rng.uniform(0.7, extent - 0.7, 3).astype(np.float32)
        loc[2] = size * 0.5
        xyz.append((pts * size + loc).astype(np.float32))
        sem.append(np.full(count, 1 + _KINDS.index(kind), np.int32))
        inst.append(np.full(count, i + 1, np.int32))
    xyz, sem, inst = np.concatenate(xyz), np.concatenate(sem), np.concatenate(inst)
    pad = n_points - xyz.shape[0]
    xyz = np.concatenate([xyz, np.zeros((pad, 3), np.float32)])
    sem = np.concatenate([sem, np.zeros(pad, np.int32)])
    inst = np.concatenate([inst, np.zeros(pad, np.int32)])
    valid = np.ones(n_points, bool)
    if pad:
        valid[-pad:] = False
    perm = rng.permutation(n_points)
    return dict(xyz=xyz[perm], valid=valid[perm], sem_label=sem[perm], inst_label=inst[perm])


def seed_rng(seed: int, *key: int) -> np.random.Generator:
    """A NumPy generator for ``(seed, *key)`` alone."""
    return np.random.default_rng(np.random.SeedSequence(entropy=int(seed), spawn_key=key))


def seed_int(seed: int, *key: int) -> int:
    """A 63-bit integer for ``(seed, *key)`` alone (a generator's seed)."""
    return int(np.random.SeedSequence(entropy=int(seed), spawn_key=key).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def pool(traffic: dict, seed: int) -> list[dict]:
    """``traffic["pool"]`` distinct batches of ``traffic["batch"]`` rooms of
    ``traffic["points"]`` points (NumPy arrays), with the last
    ``invalid_tail`` share of each room's points marked invalid."""
    b, n = traffic["batch"], traffic["points"]
    tail = int(round(n * traffic.get("invalid_tail", 0.0)))
    out = []
    for i in range(traffic["pool"]):
        rng = seed_rng(seed, 1, i)
        rooms = [room(rng, n, **traffic["room"]) for _ in range(b)]
        batch = {k: np.stack([r[k] for r in rooms]) for k in rooms[0]}
        if tail:
            batch["valid"][:, -tail:] = False
        out.append(batch)
    return out


def to_device(batch: dict, device) -> dict:
    """A pool batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
