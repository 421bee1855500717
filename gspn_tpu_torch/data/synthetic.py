"""Synthetic multi-instance scenes (ScanNet-style), NumPy only.

The same generator as ``gspn_tpu/data/synthetic.py`` (default density
"count", floor background): the same ``numpy.random.Generator`` state gives
the same arrays, so the port measures the JAX bench's scenes without
importing JAX. Labels: semantic 1 + shape kind for instances, 0 for
background; instance 1..I, 0 for background; padding points are invalid.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_KINDS = ["box", "sphere", "cylinder"]


@dataclasses.dataclass
class Scene:
    xyz: np.ndarray  # (N, 3) f32
    features: np.ndarray  # (N, 0) f32: no per-point input features
    valid: np.ndarray  # (N,) bool
    sem_label: np.ndarray  # (N,) int32
    inst_label: np.ndarray  # (N,) int32
    num_instances: int


def single_object(rng: np.random.Generator, n: int, kind: str | None = None):
    """One normalized object surface: box, sphere or cylinder."""
    kind = kind or rng.choice(_KINDS)
    if kind == "sphere":
        v = rng.standard_normal((n, 3))
        pts = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
        pts *= 0.5
    elif kind == "cylinder":
        theta = rng.uniform(0, 2 * np.pi, n)
        z = rng.uniform(-0.5, 0.5, n)
        pts = np.stack([0.3 * np.cos(theta), 0.3 * np.sin(theta), z], 1)
    else:  # box surface
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


def scene(
    rng: np.random.Generator,
    n_points: int = 4096,
    max_instances: int = 8,
    extent: float = 4.0,
    bg_frac: float = 0.3,
) -> Scene:
    """A room: floor clutter (``bg_frac`` of the points) plus 2..max_instances
    objects sharing the rest equally, shuffled."""
    n_inst = int(rng.integers(2, max_instances + 1))
    n_bg = int(n_points * bg_frac)
    counts = [(n_points - n_bg) // n_inst] * n_inst

    bg = rng.uniform(0, extent, (n_bg, 3)).astype(np.float32)
    bg[:, 2] = np.abs(rng.standard_normal(n_bg).astype(np.float32)) * 0.02
    xyz = [bg]
    sem = [np.zeros(n_bg, np.int32)]
    inst = [np.zeros(n_bg, np.int32)]
    for i in range(n_inst):
        pts, kind = single_object(rng, counts[i])
        size = rng.uniform(0.3, 0.8)
        loc = rng.uniform(0.7, extent - 0.7, 3).astype(np.float32)
        loc[2] = size * 0.5
        xyz.append((pts * size + loc).astype(np.float32))
        sem.append(np.full(counts[i], 1 + _KINDS.index(kind), np.int32))
        inst.append(np.full(counts[i], i + 1, np.int32))

    xyz = np.concatenate(xyz)
    sem = np.concatenate(sem)
    inst = np.concatenate(inst)
    pad = n_points - xyz.shape[0]
    if pad > 0:
        xyz = np.concatenate([xyz, np.zeros((pad, 3), np.float32)])
        sem = np.concatenate([sem, np.zeros(pad, np.int32)])
        inst = np.concatenate([inst, np.zeros(pad, np.int32)])
    valid = np.ones(n_points, bool)
    if pad > 0:
        valid[-pad:] = False
    perm = rng.permutation(n_points)  # FPS seeds at index 0: don't bias it
    feats = np.zeros((n_points, 0), np.float32)
    return Scene(xyz[perm], feats, valid[perm], sem[perm], inst[perm], n_inst)


def scene_batch(rng, batch: int, **kw):
    """Stack ``batch`` scenes into (B, ...) arrays -> dict of np arrays."""
    scenes = [scene(rng, **kw) for _ in range(batch)]
    return {
        "xyz": np.stack([s.xyz for s in scenes]),
        "features": np.stack([s.features for s in scenes]),
        "valid": np.stack([s.valid for s in scenes]),
        "sem_label": np.stack([s.sem_label for s in scenes]),
        "inst_label": np.stack([s.inst_label for s in scenes]),
    }
