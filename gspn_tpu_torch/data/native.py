"""Host-side point preparation: the port's counterpart of
``gspn_tpu/data/native.py``, over its own copy of the C++ library
(``csrc/pointprep.cpp``).

Every function takes ``impl="auto|native|plain"``, as the ops take
``auto|cuda|plain`` (``ops/common.py``):

- ``"auto"`` and ``"native"``: the C++ library, built with ``g++`` at first
  use into ``gspn_tpu_torch/_build/`` (keyed by a hash of the source and
  flags; written to a temporary file and renamed, so concurrent builders
  never see half a library). A build or load failure raises; nothing falls
  back to NumPy.
- ``"plain"``: the NumPy version, the reference the library is held
  against.

``block_crop_xy``, ``gather_pack``, ``compact_instance_ids`` and
``morton_order`` give the same arrays on both routes. ``subsample`` does
not: the library draws with its own xorshift generator, the NumPy version
with ``Generator.choice``, so a crop depends on the route (as it depends,
in the JAX package, on whether ``native/libpointprep.so`` was built).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "pointprep.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
# no -march=native: the library must not depend on which host built it
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
IMPLS = ("auto", "native", "plain")


def _library_path() -> pathlib.Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libpointprep-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile ``csrc/pointprep.cpp`` if this source hash has no library yet;
    returns its path. Raises with the compiler's output when ``g++`` is
    missing or fails."""
    lib = _library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the point-prep library needs g++ (not on PATH); "
                           "pass impl='plain' for the NumPy version")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, "lib.so")
        cmd = [cxx, *CXX_FLAGS, "-o", so, str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(so, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built library with every entry point's ``argtypes``/``restype``."""
    lib = ctypes.CDLL(str(build()))
    i64, f32p = ctypes.c_int64, np.ctypeslib.ndpointer(np.float32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    lib.block_crop_xy.restype = i64
    lib.block_crop_xy.argtypes = [
        f32p, i64, ctypes.c_float, ctypes.c_float, ctypes.c_float, i64p, i64
    ]
    lib.sample_without_replacement.restype = None
    lib.sample_without_replacement.argtypes = [i64p, i64, i64, ctypes.c_uint64, i64p]
    lib.gather_pack.restype = None
    lib.gather_pack.argtypes = [
        f32p, f32p, i32p, i32p, i64p, i64, i64, i64, f32p, f32p, i32p, i32p, u8p,
    ]
    lib.compact_instance_ids.restype = ctypes.c_int32
    lib.compact_instance_ids.argtypes = [i32p, i64]
    lib.morton_order.restype = None
    lib.morton_order.argtypes = [f32p, i64p, i64, i64p]
    return lib


def _native(impl: str) -> ctypes.CDLL | None:
    """The library for ``"auto"``/``"native"``, None for ``"plain"``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be auto|native|plain, got {impl!r}")
    return None if impl == "plain" else library()


def block_crop_xy(xyz: np.ndarray, cx: float, cy: float, half: float, impl: str = "auto"):
    """Indices of points with |x-cx|, |y-cy| <= half (input order)."""
    lib = _native(impl)
    xyz = np.ascontiguousarray(xyz, np.float32)
    if lib is None:
        sel = np.all(np.abs(xyz[:, :2] - [cx, cy]) <= half, axis=1)
        return np.where(sel)[0].astype(np.int64)
    out = np.empty(len(xyz), np.int64)
    n = lib.block_crop_xy(xyz, len(xyz), cx, cy, half, out, len(xyz))
    return out[:n]


def subsample(idx: np.ndarray, k: int, seed: int, impl: str = "auto") -> np.ndarray:
    """k distinct elements of idx, deterministic in (idx, k, seed, route)."""
    lib = _native(impl)
    idx = np.ascontiguousarray(idx, np.int64)
    if lib is None:
        rng = np.random.default_rng(seed)
        return rng.choice(idx, k, replace=False).astype(np.int64)
    if not 0 <= k <= len(idx):
        raise ValueError(f"subsample: k={k} of {len(idx)} indices")
    scratch = idx.copy()
    out = np.empty(k, np.int64)
    lib.sample_without_replacement(scratch, len(idx), k, seed, out)
    return out


def gather_pack(xyz, feats, sem, inst, idx, num_points: int, impl: str = "auto"):
    """Gather rows at idx into fixed-size padded arrays plus a validity
    mask: ``(xyz, feats, sem, inst, valid)``."""
    lib = _native(impl)
    xyz = np.ascontiguousarray(xyz, np.float32)
    fdim = feats.shape[1] if feats is not None and feats.size else 0
    feats = np.ascontiguousarray(feats if fdim else np.zeros((len(xyz), 0)), np.float32)
    sem = np.ascontiguousarray(sem, np.int32)
    inst = np.ascontiguousarray(inst, np.int32)
    idx = np.ascontiguousarray(idx, np.int64)
    n_sel = min(len(idx), num_points)
    if lib is None:
        out_xyz = np.zeros((num_points, 3), np.float32)
        out_feats = np.zeros((num_points, fdim), np.float32)
        out_sem = np.zeros(num_points, np.int32)
        out_inst = np.zeros(num_points, np.int32)
        valid = np.zeros(num_points, bool)
        sel = idx[:n_sel]
        out_xyz[:n_sel] = xyz[sel]
        if fdim:
            out_feats[:n_sel] = feats[sel]
        out_sem[:n_sel] = sem[sel]
        out_inst[:n_sel] = inst[sel]
        valid[:n_sel] = True
        return out_xyz, out_feats, out_sem, out_inst, valid
    if n_sel and (idx[:n_sel].min() < 0 or idx[:n_sel].max() >= len(xyz)):
        raise IndexError(f"gather_pack: indices outside [0, {len(xyz)})")
    out_xyz = np.empty((num_points, 3), np.float32)
    out_feats = np.empty((num_points, max(fdim, 1)), np.float32)
    out_sem = np.empty(num_points, np.int32)
    out_inst = np.empty(num_points, np.int32)
    valid = np.empty(num_points, np.uint8)
    lib.gather_pack(xyz, feats if fdim else out_feats, sem, inst, idx, n_sel, num_points,
                    fdim, out_xyz, out_feats, out_sem, out_inst, valid)
    return out_xyz, out_feats[:, :fdim], out_sem, out_inst, valid.astype(bool)


def _spread3(v: np.ndarray) -> np.ndarray:
    v = v & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def morton_order(xyz: np.ndarray, idx: np.ndarray, impl: str = "auto") -> np.ndarray:
    """Reorder ``idx`` ascending by the Morton (z-order) code of
    ``xyz[idx]`` over the selection's own AABB (21 bits an axis, quantized
    in double precision; stable on equal codes). A spatially coherent point
    order lets the group kernels' AABB tiles prune."""
    lib = _native(impl)
    xyz = np.ascontiguousarray(xyz, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    if lib is not None:
        if len(idx) and (idx.min() < 0 or idx.max() >= len(xyz)):
            raise IndexError(f"morton_order: indices outside [0, {len(xyz)})")
        out = np.empty(len(idx), np.int64)
        lib.morton_order(xyz, idx, len(idx), out)
        return out
    if len(idx) == 0:
        return idx.copy()
    p = xyz[idx].astype(np.float64)
    lo = p.min(axis=0)
    ext = p.max(axis=0) - lo
    scale = np.where(ext > 0.0, 2097151.0 / np.where(ext > 0.0, ext, 1.0), 0.0)
    q = np.clip((p - lo) * scale, 0.0, 2097151.0).astype(np.uint64)
    code = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << np.uint64(1))
            | (_spread3(q[:, 2]) << np.uint64(2)))
    return idx[np.argsort(code, kind="stable")]


def _compact_instance_ids_numpy(inst: np.ndarray) -> tuple[np.ndarray, int]:
    out = np.zeros_like(inst)
    mapping: dict[int, int] = {}
    for i, v in enumerate(inst):
        if v > 0:
            if v not in mapping:
                mapping[v] = len(mapping) + 1
            out[i] = mapping[v]
    return out, len(mapping)


def compact_instance_ids(inst: np.ndarray, impl: str = "auto") -> tuple[np.ndarray, int]:
    """Remap positive ids to 1..K by first appearance; 0 and below become 0.
    The library's table holds 4095 ids: beyond, it reports an overflow and
    the NumPy loop maps the ids (the same result)."""
    lib = _native(impl)
    inst = np.ascontiguousarray(inst, np.int32).copy()
    if lib is None:
        return _compact_instance_ids_numpy(inst)
    original = inst.copy()  # the library may rewrite part of it before overflowing
    k = lib.compact_instance_ids(inst, len(inst))
    if k < 0:
        return _compact_instance_ids_numpy(original)
    return inst, int(k)


# Per-point batch keys morton_sort_batch co-sorts (everything indexed by
# the point axis must be listed here, or scenes would desynchronize).
_PER_POINT_KEYS = frozenset({"xyz", "valid", "features", "inst_label", "sem_label"})


def morton_sort_batch(batch: dict, extra_per_point: tuple[str, ...] = (),
                      impl: str = "auto") -> dict:
    """Reorder every scene's per-point arrays into Morton order: valid
    points z-ordered first, padding rows kept at the end. For sources
    without a prep-time ``morton=`` knob (synthetic scenes, object
    datasets).

    Per-point keys come from an explicit allowlist (``_PER_POINT_KEYS``
    plus ``extra_per_point``), not from their shapes: a listed key that is
    not a ``(B, N, ...)`` array raises, and so does an unlisted key that
    looks per-point, at the first batch."""
    xyz = np.asarray(batch["xyz"])
    b, n = xyz.shape[:2]
    valid = np.asarray(batch.get("valid", np.ones((b, n), bool)), bool)
    allowed = _PER_POINT_KEYS | set(extra_per_point)
    per_point = []
    for k, v in batch.items():
        looks_per_point = (hasattr(v, "shape") and np.ndim(v) >= 2
                           and v.shape[0] == b and v.shape[1] == n)
        if k in allowed:
            arr = np.asarray(batch[k])
            if not (arr.ndim >= 2 and arr.shape[:2] == (b, n)):
                raise ValueError(
                    f"morton_sort_batch: per-point key {k!r} must be a "
                    f"(B={b}, N={n}, ...) array, got shape {arr.shape}")
            per_point.append(k)
        elif looks_per_point:
            raise ValueError(
                f"morton_sort_batch: key {k!r} has per-point shape "
                f"{tuple(np.shape(v))} but is not in the per-point allowlist; pass it "
                "via extra_per_point= (to co-sort) or rename it if it is scene-level")
    out = {k: (np.array(v, copy=True) if k in per_point else v) for k, v in batch.items()}
    for i in range(b):
        vidx = np.flatnonzero(valid[i]).astype(np.int64)
        iidx = np.flatnonzero(~valid[i]).astype(np.int64)
        order = np.concatenate([morton_order(xyz[i], vidx, impl), iidx])
        for k in per_point:
            out[k][i] = np.asarray(batch[k])[i][order]
    return out
