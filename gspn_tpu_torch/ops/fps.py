"""Farthest point sampling: the exact greedy chain (plain PyTorch version and
CUDA kernels ``csrc/fps.cu``: one sub-block of a CTA per row, short rows
sharing a CTA, or one thread-block cluster per row beyond one block) and
the segmented / spatial compositions around it.

Counterpart of ``gspn_tpu/ops/fps.py``. Greedy: seed with the first valid
point, then repeatedly pick the point with the largest minimum squared
distance to the picked set, ties to the lowest index; invalid points are
never picked while a valid one remains.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.ops.common import gspn_op, resolve_impl, sqdist_components
from gspn_tpu_torch.ops.morton import morton_codes

_BIG = 1e10
# the longest row (or cluster CTA's slice) one block holds: both kernels
# keep the minimum in registers and the coordinates in shared memory (12 B
# a point of Hopper's 227 KB a block); this bound, set when the cluster
# kernel kept 16 B a point, is kept so that no row it took is refused; a
# longer row is spread over a cluster of CTAs, each holding a slice this long
FPS_MAX_N = (232448 - 4096) // 16
# 2, 4 and 8 are portable cluster sizes; 16 is Hopper's non-portable maximum
FPS_CLUSTER_SIZES = (1, 2, 4, 8, 16)
FPS_CLUSTER_MAX_N = FPS_CLUSTER_SIZES[-1] * FPS_MAX_N
# above one block, 8 CTAs while their slices stay within this many points,
# else 16: the fastest sizes measured on an H100 (PERF.md, section 6)
FPS_CLUSTER_SLICE = 4096

KERNEL = _cuda.KERNELS["fps"]
CLUSTER_KERNEL = _cuda.KERNELS["fps_cluster"]


def fps_cluster_size(n: int) -> int:
    """CTAs that share one row of ``n`` points: 1 (one block, ``fps_kernel``)
    up to ``FPS_MAX_N``; above it 8 while slices of ``ceil(n / 8)`` points
    stay within ``FPS_CLUSTER_SLICE``, else 16. A pick costs a cluster
    barrier whatever the size, so more CTAs with shorter slices were faster
    on the card up to 8 (2 x 14273 and 4 x 16384 points) and 16 from 65536
    points. Raises ``ValueError`` above ``FPS_CLUSTER_MAX_N``."""
    if n <= FPS_MAX_N:
        return 1
    if n <= 8 * FPS_CLUSTER_SLICE:
        return 8
    if n <= FPS_CLUSTER_MAX_N:
        return 16
    raise ValueError(
        f"the fps kernels hold at most {FPS_CLUSTER_MAX_N} points per row (a cluster "
        f"of {FPS_CLUSTER_SIZES[-1]} CTAs x {FPS_MAX_N}); got N={n} (use segments>1 "
        "to cut the scene into chains)"
    )


@functools.cache
def _check_cluster_resident(device_index: int, n: int, cs: int) -> None:
    """Raise unless a cluster of ``cs`` CTAs holding a row of ``n`` points
    can be resident on the device (``cudaOccupancyMaxActiveClusters``),
    once per shape."""
    lib = _cuda.library()
    count = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.gspn_fps_cluster_occupancy(n, cs, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"fps cluster occupancy query failed: "
                           f"{lib.gspn_error_string(err).decode()} ({err})")
    if count.value < 1:
        raise RuntimeError(
            f"a cluster of {cs} CTAs holding {-(-n // cs)} points each (N={n}) cannot be "
            "resident on this device (cudaOccupancyMaxActiveClusters = 0)"
        )


def _fps_plain(xyz: torch.Tensor, npoint: int, valid: torch.Tensor | None):
    """Plain PyTorch greedy FPS over all rows at once (the JAX package's
    ``_fps_single_xla``, vmapped)."""
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    if valid is None:
        mind = torch.full((b, n), _BIG, dtype=torch.float32, device=xyz.device)
        prev = torch.zeros(b, dtype=torch.long, device=xyz.device)
    else:
        mind = torch.where(
            valid,
            torch.full((b, n), _BIG, dtype=torch.float32, device=xyz.device),
            torch.full((b, n), -1.0, dtype=torch.float32, device=xyz.device),
        )
        prev = valid.to(torch.uint8).argmax(dim=1)  # first valid (0 if none)
    out = torch.empty((b, npoint), dtype=torch.long, device=xyz.device)
    out[:, 0] = prev
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    for i in range(1, npoint):
        c = xyz[rows, prev]  # (B, 3)
        d = sqdist_components(x - c[:, 0:1], y - c[:, 1:2], z - c[:, 2:3])
        mind = torch.minimum(mind, d)
        prev = mind.argmax(dim=1)  # first occurrence: lowest index wins ties
        out[:, i] = prev
    return out.to(torch.int32)


def _fps_cuda(xyz: torch.Tensor, npoint: int, valid: torch.Tensor | None,
              cluster: int | None = None):
    """The kernels' greedy FPS; ``cluster`` overrides the cluster size
    :func:`fps_cluster_size` picks (for timing one size against another)."""
    b, n, _ = xyz.shape
    cs = fps_cluster_size(n) if cluster is None else cluster
    if cs not in FPS_CLUSTER_SIZES or -(-n // cs) > FPS_MAX_N:
        raise ValueError(f"cluster size {cs} cannot hold a row of N={n} points")
    xyz = xyz.contiguous()
    _cuda.check_cuda_input("xyz", xyz, torch.float32, (b, n, 3))
    v = None
    if valid is not None:
        v = _cuda.flag_bytes(valid)
        _cuda.check_cuda_input("valid", v, torch.uint8, (b, n))
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    if not (b and npoint):
        return out
    if cs == 1:
        KERNEL.launch(xyz.device, _cuda.ptr(xyz), _cuda.ptr(v), b, n, npoint, _cuda.ptr(out))
    else:
        _check_cluster_resident(xyz.device.index, n, cs)
        CLUSTER_KERNEL.launch(xyz.device, _cuda.ptr(xyz), _cuda.ptr(v), b, n, npoint, cs,
                              _cuda.ptr(out))
    return out


def _fps_segmented(npoint, xyz, valid, segments, segment_mode, impl):
    """``segments`` independent greedy chains (``gspn_tpu/ops/fps.py``
    ``_fps_segmented``): contiguous or strided sub-samples, or contiguous
    chains over the Morton-sorted view ("spatial"). Output columns
    interleave the chains round-robin; all-invalid segments fall back to
    the scene's first valid point."""
    b, n, _ = xyz.shape
    if n % segments or npoint % segments:
        raise ValueError(
            f"fps segments={segments} must divide both N={n} and npoint={npoint}"
        )
    if segment_mode not in ("contiguous", "strided", "spatial"):
        raise ValueError(
            f"segment_mode must be contiguous|strided|spatial, got {segment_mode}"
        )
    if segment_mode == "spatial":
        sxyz, svalid, sidx = spatial_sorted_view(xyz, valid)
        pos = _fps_segmented(npoint, sxyz, svalid, segments, "contiguous", impl)
        return torch.gather(sidx, 1, pos.long())
    m = npoint // segments
    ns = n // segments
    if segment_mode == "contiguous":
        xs = xyz.reshape(b * segments, ns, 3)
        vs = None if valid is None else valid.reshape(b * segments, ns)
    else:
        xs = xyz.reshape(b, ns, segments, 3).transpose(1, 2).reshape(b * segments, ns, 3)
        vs = (
            None
            if valid is None
            else valid.reshape(b, ns, segments).transpose(1, 2).reshape(b * segments, ns)
        )
    idx = farthest_point_sample(m, xs, vs, impl=impl)  # local indices per chain
    offs = torch.arange(segments, dtype=torch.int32, device=xyz.device)
    if segment_mode == "contiguous":
        gidx = idx.reshape(b, segments, m) + (offs * ns)[None, :, None]
    else:
        gidx = idx.reshape(b, segments, m) * segments + offs[None, :, None]
    if valid is not None:
        seg_has = vs.reshape(b, segments, ns).any(dim=2)  # (B, S)
        first_valid = valid.to(torch.uint8).argmax(dim=1)
        first_valid = torch.where(
            valid.any(dim=1), first_valid, torch.full_like(first_valid, n - 1)
        ).to(torch.int32)
        gidx = torch.where(seg_has[:, :, None], gidx, first_valid[:, None, None])
    # round-robin interleave: column c holds chain c % S's pick c // S
    return gidx.transpose(1, 2).reshape(b, npoint).to(torch.int32)


def spatial_sorted_view(xyz: torch.Tensor, valid: torch.Tensor | None):
    """The Morton-sorted view the spatial FPS runs on: a stable sort by
    Morton code (invalid points last). Returns ``(sxyz (B,N,3), svalid
    (B,N) bool or None, sidx (B,N) int32)``; ``sidx`` maps sorted positions
    to raw indices."""
    codes = morton_codes(xyz, valid)
    order = torch.sort(codes, dim=1, stable=True).indices
    sxyz = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    svalid = None if valid is None else torch.gather(valid, 1, order)
    return sxyz, svalid, order.to(torch.int32)


def shared_eligible_fps_segments(segments: int, npoints, n: int) -> int:
    """Segment count for ONE pass serving several prefix consumers: the
    configured value only if it is eligible for every prefix length."""
    for p in npoints:
        if eligible_fps_segments(segments, p, n) != segments:
            return 1
    return segments


def eligible_fps_segments(segments: int, npoint: int, n: int) -> int:
    """The configured segment count when it divides both sizes and each
    chain keeps at least 8 picks, else 1 (exact)."""
    if (
        segments > 1
        and npoint % segments == 0
        and n % segments == 0
        and npoint >= 8 * segments
    ):
        return segments
    return 1


def farthest_point_sample(
    npoint: int,
    xyz: torch.Tensor,
    valid: torch.Tensor | None = None,
    *,
    impl: str = "auto",
    segments: int = 1,
    segment_mode: str = "contiguous",
) -> torch.Tensor:
    """Greedy FPS, ``(B, N, 3) -> (B, npoint)`` int32 indices into N.

    ``segments > 1`` runs the segmented parallel-chain approximation (see
    :func:`_fps_segmented`); ``impl`` is ``auto|cuda|plain``
    (``ops/common.py``)."""
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    if segments < 1:
        raise ValueError(f"segments must be >= 1, got {segments}")
    if segments > 1:
        return _fps_segmented(npoint, xyz, valid, segments, segment_mode, impl)
    return _fps_op(xyz, valid, npoint, impl)


@gspn_op("fps")
def _fps_op(xyz: torch.Tensor, valid: torch.Tensor | None, npoint: int,
            impl: str) -> torch.Tensor:
    """Exact greedy FPS as one opaque op: the kernels (``fps`` or, above one
    block's row, ``fps_cluster``) or the plain version's pick loop."""
    if resolve_impl(impl, xyz) == "cuda":
        return _fps_cuda(xyz, npoint, valid)
    return _fps_plain(xyz, npoint, valid)


@torch.library.register_fake(_fps_op)
def _(xyz, valid, npoint, impl):
    return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int32)
