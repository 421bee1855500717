"""Synthetic multi-instance scenes (ScanNet-style), NumPy only.

The same generator as ``gspn_tpu/data/synthetic.py``, its generator
families (:data:`FAMILIES`) included: the same ``numpy.random.Generator``
state gives the same arrays, so the port measures the JAX bench's and
eval's scenes without importing JAX. Labels: semantic 1 + shape kind for
instances, 0 for background; instance 1..I, 0 for background; padding
points are invalid.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_KINDS = ["box", "sphere", "cylinder"]


@dataclasses.dataclass
class Scene:
    xyz: np.ndarray  # (N, 3) f32
    features: np.ndarray  # (N, F) f32 (F may be 0)
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
    feature_dim: int = 0,
    density: str = "count",
    size_range: tuple[float, float] = (0.3, 0.8),
    bg_mode: str = "floor",
) -> Scene:
    """A room: background clutter plus 2..max_instances objects, shuffled.

    ``density`` splits the points between background and instances:
    "count" (default) gives the background ``bg_frac`` of them and the
    instances equal shares of the rest (instances denser than background);
    "area" shares them by surface area (floor ``extent**2``, an instance
    ``3 * size**2``) at one density; "sparse" is "area" with the instances
    at half the background's density. ``bg_mode`` "floor" (default) puts
    the clutter on the ground plane, "volume" fills the room's lower half.
    ``feature_dim`` > 0 adds uniform per-point features, drawn last. The
    draws come in the JAX package's order, so the default stays the
    sequence every fixture and slice rests on."""
    n_inst = int(rng.integers(2, max_instances + 1))
    if density == "count":
        n_bg = int(n_points * bg_frac)
        counts = [(n_points - n_bg) // n_inst] * n_inst
        sizes = None  # drawn in the loop below, as the default sequence has them
    elif density in ("area", "sparse"):
        sizes = rng.uniform(size_range[0], size_range[1], n_inst)
        w = np.concatenate([[extent * extent], 3.0 * sizes**2])
        if density == "sparse":
            w[1:] *= 0.5
        w = w / w.sum()
        counts = np.maximum((n_points * w[1:]).astype(int), 16)
        n_bg = n_points - int(counts.sum())
        if n_bg < 0:  # tiny scenes: shrink the instances to fit
            counts = np.maximum((counts * n_points) // (counts.sum() + 16), 8)
            # drop instances from the end, then trim the first, so that no
            # instance counted in the labels loses its points to the crop
            while len(counts) > 1 and counts.sum() > n_points:
                counts = counts[:-1]
            if counts.sum() > n_points:
                counts[0] = n_points
            n_inst = len(counts)
            sizes = sizes[:n_inst]
            n_bg = max(n_points - int(counts.sum()), 0)
        counts = list(counts)
    else:
        raise ValueError(f"density must be count|area|sparse, got {density!r}")

    if bg_mode == "floor":
        bg = rng.uniform(0, extent, (n_bg, 3)).astype(np.float32)
        bg[:, 2] = np.abs(rng.standard_normal(n_bg).astype(np.float32)) * 0.02
    elif bg_mode == "volume":
        bg = rng.uniform(0, extent, (n_bg, 3)).astype(np.float32)
        bg[:, 2] *= 0.5  # room height ~ extent/2
    else:
        raise ValueError(f"bg_mode must be floor|volume, got {bg_mode!r}")
    xyz = [bg]
    sem = [np.zeros(n_bg, np.int32)]
    inst = [np.zeros(n_bg, np.int32)]
    for i in range(n_inst):
        pts, kind = single_object(rng, counts[i])
        size = rng.uniform(size_range[0], size_range[1]) if sizes is None else float(sizes[i])
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
    feats = (rng.uniform(0, 1, (n_points, feature_dim)).astype(np.float32) if feature_dim
             else np.zeros((n_points, 0), np.float32))
    return Scene(xyz[perm], feats, valid[perm], sem[perm], inst[perm], n_inst)


# The generator families of the JAX package (``run_eval --family``): the
# default's instances are denser than its background, which the spatial
# segmented FPS's equal-count Morton tiles key on; the others vary or
# invert that.
FAMILIES: dict[str, dict] = {
    "default": {},
    "uniform": {"density": "area"},  # instances at background density
    "sparse": {"density": "sparse"},  # instances sparser than background
    "heavy_bg": {"bg_frac": 0.7},  # background dominates the count
    "many_small": {"max_instances": 16, "size_range": (0.15, 0.35)},
    "few_large": {"max_instances": 3, "size_range": (0.8, 1.4)},
    "volume_bg": {"bg_mode": "volume"},  # no floor structure
}


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
