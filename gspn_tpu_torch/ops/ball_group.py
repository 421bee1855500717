"""Fused multi-radius ball query + group + centre subtract.

Counterpart of ``gspn_tpu/ops/ball_group.py::query_ball_group_multi``. The
CUDA routes are ``csrc/ball_group.cu``: ``select="first"`` (the scene
staged through shared memory in tiles for a CTA of queries, one shared
distance for all concentric scales, a query's scan split over several
warps when queries are few, early exit) and ``select="strided"`` (the same
staging and split, each point tested once and its ballot kept, then the
hits of rank ``floor(j * total / K)`` read from the ballots); the plain
route is the ball query plus a ``group_point`` gather.
"""

from __future__ import annotations

import torch

from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.ops.ball_query import (
    ball_query_plain, ball_scan_cuda, check_select, query_ball_point_multi, scan_outputs_like,
    strided_scan_cuda,
)
from gspn_tpu_torch.ops.common import gspn_op, resolve_impl
from gspn_tpu_torch.ops.grouping import group_point

KERNEL = _cuda.KERNELS["ball_group"]
STRIDED_KERNEL = _cuda.KERNELS["ball_group_strided"]


def _ball_group_plain(radii, nsamples, xyz1, xyz2, valid1, select):
    out = []
    for r, k in zip(radii, nsamples, strict=True):
        idx, cnt = ball_query_plain(r, k, xyz1, xyz2, valid1, select)
        local = group_point(xyz1, idx) - xyz2[:, :, None, :]
        out.append((idx, cnt, local))
    return out


def query_ball_group_multi(
    radii, nsamples, xyz1, xyz2, valid1=None, *, impl: str = "auto", select=None
):
    """Per scale ``(idx (B,M,K) int32, cnt (B,M) int32, local (B,M,K,3)
    f32)`` where ``local == group_point(xyz1, idx) - xyz2[:, :, None]``
    bit for bit. ``xyz1 (B,N,3)`` dataset, ``xyz2 (B,M,3)`` query centres,
    ``valid1 (B,N)`` optional; ``select`` "first" (default) or "strided"."""
    flat = _ball_group_op(xyz1, xyz2, valid1, [float(r) for r in radii],
                          [int(k) for k in nsamples], check_select(select), impl)
    return [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)]


def query_ball_multi_v2(
    radii, nsamples, xyz1, xyz2, valid1=None, *, impl: str = "auto", select=None
):
    """The index-only form of :func:`query_ball_group_multi`: per scale
    ``(idx (B,M,K) int32, cnt (B,M) int32)``, a drop-in for
    ``ops.query_ball_point_multi``, whose op it runs (on the card the group
    kernels without their coordinate stores, ``csrc/ball_query.cu``)."""
    return query_ball_point_multi(radii, nsamples, xyz1, xyz2, valid1, impl=impl, select=select)


@gspn_op("ball_group")
def _ball_group_op(xyz1: torch.Tensor, xyz2: torch.Tensor, valid1: torch.Tensor | None,
                   radii: list[float], nsamples: list[int], select: str,
                   impl: str) -> list[torch.Tensor]:
    """:func:`query_ball_group_multi` as one opaque op, its outputs flat:
    ``[idx, cnt, local]`` a scale."""
    if resolve_impl(impl, xyz1) == "cuda":
        if select == "strided":
            outs = _ball_group_strided_cuda(radii, nsamples, xyz1, xyz2, valid1)
        else:
            outs = _ball_group_cuda(radii, nsamples, xyz1, xyz2, valid1)
    else:
        outs = _ball_group_plain(radii, nsamples, xyz1, xyz2, valid1, select)
    return [t for out in outs for t in out]


@torch.library.register_fake(_ball_group_op)
def _(xyz1, xyz2, valid1, radii, nsamples, select, impl):
    return [t for k in nsamples for t in scan_outputs_like(xyz2, k, True)]


def _ball_group_cuda(radii, nsamples, xyz1, xyz2, valid1=None, split: int = 0):
    """The first-K kernel at the kernel's own split (warps a query), or at
    ``split`` (1, 2, 4, 8 or 16) to time one split against another."""
    return ball_scan_cuda(KERNEL, radii, nsamples, xyz1, xyz2, valid1, True, split)


def _ball_group_strided_cuda(radii, nsamples, xyz1, xyz2, valid1=None, plan=None):
    """The strided kernel at ``strided_plan``'s plan, or at ``plan`` =
    (split, direct) to time one plan against another."""
    return strided_scan_cuda(STRIDED_KERNEL, radii, nsamples, xyz1, xyz2, valid1, True, plan)
