"""Ball query (fixed-radius neighborhood), first-K or strided selection.

Counterpart of ``gspn_tpu/ops/ball_query.py``: for each query, the first
``nsample`` dataset points in input order with squared distance strictly
below ``radius**2`` (``select="first"``), or, once a query has ``total >
nsample`` hits, those of rank ``floor(j * total / nsample)`` in the
ascending hit list (``select="strided"``, a systematic sample that does
not collapse to one corner of the ball on spatially sorted layouts); slots
past the count repeat the first hit; an empty query gets index 0 and count
0; the count is capped at ``nsample`` either way.

``query_ball_point(_multi)`` take ``impl="auto|cuda|plain"``: the CUDA
route is ``csrc/ball_query.cu``, the ball group's kernels without their
coordinate stores, one entry point per selection, at the ball group's plan
(the first-K kernel's own split rule; :func:`strided_plan` for strided);
the fused ball group (``ops/ball_group.py``) shares :func:`ball_scan_cuda`
and :func:`strided_scan_cuda`, and the strided box group
:func:`strided_plan`.
"""

from __future__ import annotations

import ctypes

import torch

from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.ops.common import f32_scalar, gspn_op, pairwise_sqdist, resolve_impl

KERNEL = _cuda.KERNELS["ball_query"]
STRIDED_KERNEL = _cuda.KERNELS["ball_query_strided"]
MAX_SCALES = 4  # csrc/group_first.cuh kMaxScales
# the strided groups' kernel (csrc/group_strided.cuh): warps a CTA
# (kCtaWarps; kDirectWarps when direct), points a tile (kTile) and a step
# (32 * kGroups)
STRIDED_CTA_WARPS = 16
STRIDED_DIRECT_WARPS = 4
STRIDED_TILE = 2048
STRIDED_STEP = 128
STRIDED_SPLITS = (1, 2, 4, 8, 16)
# strided_plan's rule, fitted to every plan timed at the strided groups'
# shapes on an H100 (PERF.md, section 6): a warp a query reading the scene
# from device memory (direct) up to STRIDED_DIRECT_POINTS points a scene;
# else the scene staged for a CTA, no split below a tile, then the warps a
# query doubled while the launch stays within STRIDED_TARGET_WARPS warps
# and each warp keeps STRIDED_MIN_WARP_POINTS of the scene. A CTA keeps its
# ballots in shared memory up to STRIDED_SMEM_BALLOTS bytes (two staged
# CTAs an SM), else in a scratch buffer.
STRIDED_DIRECT_POINTS = 1024
STRIDED_TARGET_WARPS = 2048
STRIDED_MIN_WARP_POINTS = 512
STRIDED_SMEM_BALLOTS = 24 * 1024


def check_select(select: str | None) -> str:
    """``select`` normalized to "first" or "strided"; anything else raises
    ``ValueError``, as the JAX package's ``_check_select`` does."""
    if select is not None and select not in ("first", "strided"):
        raise ValueError(f"select must be first|strided, got {select!r}")
    return select or "first"


def finalize(idx_asc: torch.Tensor, cnt: torch.Tensor, nsample: int):
    """Replicate-first padding and zero rows for empty queries."""
    first = idx_asc[..., 0:1]
    k = torch.arange(nsample, device=idx_asc.device)
    idx = torch.where(k < cnt[..., None], idx_asc, first)
    idx = torch.where(cnt[..., None] > 0, idx, torch.zeros_like(idx))
    return idx.to(torch.int32), cnt.to(torch.int32)


def first_k_hits(hit: torch.Tensor, k: int) -> torch.Tensor:
    """Ascending positions of the first ``k`` True entries of each row of
    ``hit (..., N)``; unfilled slots read 0 (masked later by the count).
    Positions are unique, so the selection has no ties to break."""
    n = hit.shape[-1]
    iota = torch.arange(n, dtype=torch.int32, device=hit.device)
    pos = torch.where(hit, iota, torch.full_like(iota, n))
    first = torch.topk(pos, k, dim=-1, largest=False, sorted=True).values
    return torch.where(first >= n, torch.zeros_like(first), first)


def strided_target_mask(hit: torch.Tensor, nsample: int) -> torch.Tensor:
    """Refine a ``(..., N)`` hit mask to the ``select="strided"`` subset:
    with ``total > nsample`` hits in a row, keep the hit of rank ``r`` when
    ``j = ceil(r * nsample / total)`` satisfies ``j * total < r * nsample +
    nsample`` and ``j < nsample`` (rank ``floor(j * total / nsample)`` for
    some slot ``j``); rows with ``total <= nsample`` are unchanged. In int64,
    so it equals the CUDA kernels' 64-bit arithmetic at every size and the
    JAX package's int32 wherever that does not overflow."""
    hit_i = hit.to(torch.int64)
    total = hit_i.sum(dim=-1, keepdim=True)
    rank = torch.cumsum(hit_i, dim=-1) - hit_i  # exclusive
    j = (rank * nsample + total - 1) // torch.clamp(total, min=1)
    target = (j * total < rank * nsample + nsample) & (j < nsample)
    return hit & ((total <= nsample) | target)


def ball_query_plain(radius: float, nsample: int, xyz1, xyz2, valid1=None,
                     select: str = "first"):
    """``xyz1 (B,N,3)`` dataset, ``xyz2 (B,M,3)`` queries -> ``idx
    (B,M,nsample)`` int32, ``cnt (B,M)`` int32."""
    d2 = pairwise_sqdist(xyz2, xyz1)  # (B, M, N)
    hit = d2 < f32_scalar(float(radius) * float(radius), d2.device)
    if valid1 is not None:
        hit = hit & valid1[:, None, :]
    cnt = torch.clamp(hit.sum(dim=-1), max=nsample)
    if check_select(select) == "strided":
        hit = strided_target_mask(hit, nsample)
    return finalize(first_k_hits(hit, nsample), cnt, nsample)


def strided_words(n: int) -> int:
    """Ballot words a query and scale over ``n`` points: one bit a point,
    in whole steps (``csrc/group_strided.cuh`` strided_words)."""
    return -(-n // STRIDED_STEP) * (STRIDED_STEP // 32)


def strided_split(nq: int, n: int) -> tuple[int, bool]:
    """``(warps a query, direct)`` of the strided groups' kernel for ``nq``
    queries over scenes of ``n`` points (see ``STRIDED_DIRECT_POINTS``)."""
    if n <= STRIDED_DIRECT_POINTS:
        return 1, True
    split = 1
    if n < STRIDED_TILE:
        return split, False
    while (split < STRIDED_SPLITS[-1] and nq * split * 2 <= STRIDED_TARGET_WARPS
           and n // (split * 2) >= STRIDED_MIN_WARP_POINTS):
        split *= 2
    return split, False


def strided_plan(nq: int, nscales: int, n: int, device, plan=None):
    """``(split, direct, ballots)`` for the strided groups' kernel: warps a
    query and direct mode (:func:`strided_split`'s, or ``plan`` = (split,
    direct) to time one against another) and the kernel's ballot scratch,
    an int32 ``(nq, nscales, strided_words(n))`` tensor, or None where a
    CTA's ballots fit ``STRIDED_SMEM_BALLOTS`` of shared memory."""
    split, direct = plan or strided_split(nq, n)
    if split not in STRIDED_SPLITS or (direct and split != 1):
        raise ValueError(f"a strided plan is a split in {STRIDED_SPLITS}, or direct at split 1; "
                         f"got {(split, direct)}")
    words = strided_words(n)
    warps = STRIDED_DIRECT_WARPS if direct else STRIDED_CTA_WARPS
    if warps // split * nscales * words * 4 <= STRIDED_SMEM_BALLOTS:
        return split, direct, None
    return split, direct, torch.empty((nq, nscales, words), dtype=torch.int32, device=device)


def ball_scan_cuda(kernel, radii, nsamples, xyz1, xyz2, valid1, with_coords, *extra):
    """Launch one of the ball scans (``kernel``: ball_group(_strided) with
    coordinates, ball_query(_strided) without; ``extra``, the plan, follows
    the output pointers, as the kernel's C entry point takes it: the split
    for first-K, or :func:`strided_scan_cuda`'s). Returns per scale ``(idx
    (B,M,K) int32, cnt (B,M) int32[, local (B,M,K,3) f32])``."""
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    s = len(radii)
    if not 1 <= s <= MAX_SCALES or len(nsamples) != s:
        raise ValueError(f"the ball scan takes 1..{MAX_SCALES} (radius, K) scales, got "
                         f"{len(radii)} radii and {len(nsamples)} Ks")
    xyz1 = xyz1.contiguous()
    xyz2 = xyz2.contiguous()
    _cuda.check_cuda_input("xyz1", xyz1, torch.float32, (b, n, 3))
    _cuda.check_cuda_input("xyz2", xyz2, torch.float32, (b, m, 3))
    v = None
    if valid1 is not None:
        v = _cuda.flag_bytes(valid1)
        _cuda.check_cuda_input("valid1", v, torch.uint8, (b, n))
    dev = xyz1.device
    outs = [
        (
            torch.empty((b, m, k), dtype=torch.int32, device=dev),
            torch.empty((b, m), dtype=torch.int32, device=dev),
        ) + ((torch.empty((b, m, k, 3), dtype=torch.float32, device=dev),)
             if with_coords else ())
        for k in nsamples
    ]
    if b and m:
        # r^2 in Python double, rounded once to f32 (as the JAX package does)
        r2s = (ctypes.c_float * s)(*(float(r) * float(r) for r in radii))
        ks = (ctypes.c_int * s)(*(int(k) for k in nsamples))
        ptrs = [
            (ctypes.c_void_p * s)(*(_cuda.ptr(o[i]) for o in outs))
            for i in range(3 if with_coords else 2)
        ]
        kernel.launch(
            dev, _cuda.ptr(xyz1), _cuda.ptr(v), _cuda.ptr(xyz2), b, n, m, s,
            ctypes.addressof(r2s), ctypes.addressof(ks),
            *(ctypes.addressof(p) for p in ptrs), *extra,
        )
    return outs


def strided_scan_cuda(kernel, radii, nsamples, xyz1, xyz2, valid1, with_coords, plan=None):
    """A strided ball scan (``kernel``: ball_group_strided or
    ball_query_strided) at :func:`strided_plan`'s plan, or at ``plan`` =
    (split, direct) to time one plan against another."""
    split, direct, ballots = strided_plan(xyz2.shape[0] * xyz2.shape[1], len(radii),
                                          xyz1.shape[1], xyz1.device, plan)
    return ball_scan_cuda(kernel, radii, nsamples, xyz1, xyz2, valid1, with_coords, split,
                          int(direct), _cuda.ptr(ballots))


def _ball_query_cuda(radii, nsamples, xyz1, xyz2, valid1=None, split: int = 0):
    """The first-K query at the kernel's own split (warps a query), or at
    ``split`` (1, 2, 4, 8 or 16) to time one split against another."""
    return ball_scan_cuda(KERNEL, radii, nsamples, xyz1, xyz2, valid1, False, split)


def scan_outputs_like(xyz2: torch.Tensor, k: int, with_coords: bool) -> list[torch.Tensor]:
    """Empty ``[idx (B,M,k) int32, cnt (B,M) int32[, local (B,M,k,3)
    f32]]`` for the queries ``xyz2 (B,M,3)``: a scan's outputs at one
    scale, as the ops' fake versions give them."""
    b, m = xyz2.shape[:2]
    out = [xyz2.new_empty((b, m, k), dtype=torch.int32),
           xyz2.new_empty((b, m), dtype=torch.int32)]
    if with_coords:
        out.append(xyz2.new_empty((b, m, k, 3), dtype=torch.float32))
    return out


def query_ball_point_multi(
    radii, nsamples, xyz1, xyz2, valid1=None, *, impl: str = "auto", select=None
):
    """Concentric multi-radius ball query: per scale ``(idx (B,M,K_s)
    int32, cnt (B,M) int32)``, each as :func:`query_ball_point`."""
    flat = _ball_query_op(xyz1, xyz2, valid1, [float(r) for r in radii],
                          [int(k) for k in nsamples], check_select(select), impl)
    return [tuple(flat[i:i + 2]) for i in range(0, len(flat), 2)]


@gspn_op("ball_query")
def _ball_query_op(xyz1: torch.Tensor, xyz2: torch.Tensor, valid1: torch.Tensor | None,
                   radii: list[float], nsamples: list[int], select: str,
                   impl: str) -> list[torch.Tensor]:
    """:func:`query_ball_point_multi` as one opaque op, its outputs flat:
    ``[idx, cnt]`` a scale."""
    if resolve_impl(impl, xyz1) == "cuda":
        if select == "strided":
            outs = strided_scan_cuda(STRIDED_KERNEL, radii, nsamples, xyz1, xyz2, valid1, False)
        else:
            outs = _ball_query_cuda(radii, nsamples, xyz1, xyz2, valid1)
    else:
        outs = [ball_query_plain(r, k, xyz1, xyz2, valid1, select)
                for r, k in zip(radii, nsamples, strict=True)]
    return [t for out in outs for t in out]


@torch.library.register_fake(_ball_query_op)
def _(xyz1, xyz2, valid1, radii, nsamples, select, impl):
    return [t for k in nsamples for t in scan_outputs_like(xyz2, k, False)]


def query_ball_point(
    radius: float, nsample: int, xyz1, xyz2, valid1=None, *, impl: str = "auto", select=None
):
    """Fixed-radius neighborhood indices with replicate-first padding:
    ``xyz1 (B,N,3)`` dataset, ``xyz2 (B,M,3)`` query centres, ``valid1
    (B,N)`` optional -> ``idx (B,M,nsample) int32``, ``cnt (B,M) int32``.
    ``select`` is "first" (default) or "strided" (see the module)."""
    if xyz1.ndim != 3 or xyz2.ndim != 3:
        raise ValueError("xyz1/xyz2 must be (B, N, 3)/(B, M, 3)")
    return query_ball_point_multi(
        (radius,), (nsample,), xyz1, xyz2, valid1, impl=impl, select=select
    )[0]
