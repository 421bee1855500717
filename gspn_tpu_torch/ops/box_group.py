"""S in-box scene points per RoI, for Point RoIAlign.

Counterpart of ``gspn_tpu/ops/box_group.py::query_box_group``: the first
``s`` points in input order inside each box (inclusive ``lo <= p <= hi``;
``select="first"``) or, once a box holds ``total > s`` points, those of
rank ``floor(j * total / s)`` (``select="strided"``); replicate-first
padding, count capped at ``s``, empty rows read index 0; coordinates
relative to the box centre. The CUDA routes are ``csrc/box_group.cu``
(first-S, and strided at ``ball_query.strided_plan``'s plan).
"""

from __future__ import annotations

import torch

from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.ops.ball_query import (
    check_select,
    finalize,
    first_k_hits,
    scan_outputs_like,
    strided_plan,
    strided_target_mask,
)
from gspn_tpu_torch.ops.common import gspn_op, resolve_impl
from gspn_tpu_torch.ops.grouping import group_point

KERNEL = _cuda.KERNELS["box_group"]
STRIDED_KERNEL = _cuda.KERNELS["box_group_strided"]


def box_contains(boxes: torch.Tensor, xyz: torch.Tensor, valid=None) -> torch.Tensor:
    """``boxes (B,R,6)``, ``xyz (B,N,3)`` -> ``(B,R,N)`` bool, inclusive."""
    p = xyz[:, None, :, :]
    inside = ((p >= boxes[..., None, 0:3]) & (p <= boxes[..., None, 3:6])).all(dim=-1)
    if valid is not None:
        inside = inside & valid[:, None, :]
    return inside


def _box_group_plain(boxes, s, xyz1, valid1, select):
    """The mask [+ strided refinement] + first-s formulation
    (``_box_query_xla``)."""
    inside = box_contains(boxes, xyz1, valid1)
    cnt = torch.clamp(inside.sum(dim=-1), max=s)
    if select == "strided":
        inside = strided_target_mask(inside, s)
    idx, cnt = finalize(first_k_hits(inside, s), cnt, s)
    center = (boxes[..., 0:3] + boxes[..., 3:6]) * 0.5
    local = group_point(xyz1, idx) - center[..., None, :]
    return idx, cnt, local


def _box_group_cuda(kernel, boxes, s, xyz1, valid1, *extra):
    """Launch ``kernel``; ``extra``: the first-S kernel's split (warps a
    box, 0 for the kernel's rule), or the strided kernel's split, direct
    flag and ballots (:func:`_box_group_strided_cuda`)."""
    b, n, _ = xyz1.shape
    r = boxes.shape[1]
    xyz1 = xyz1.contiguous()
    boxes = boxes.contiguous()
    _cuda.check_cuda_input("xyz1", xyz1, torch.float32, (b, n, 3))
    _cuda.check_cuda_input("boxes", boxes, torch.float32, (b, r, 6))
    v = None
    if valid1 is not None:
        v = _cuda.flag_bytes(valid1)
        _cuda.check_cuda_input("valid1", v, torch.uint8, (b, n))
    dev = xyz1.device
    idx = torch.empty((b, r, s), dtype=torch.int32, device=dev)
    cnt = torch.empty((b, r), dtype=torch.int32, device=dev)
    local = torch.empty((b, r, s, 3), dtype=torch.float32, device=dev)
    if b and r:
        kernel.launch(
            dev, _cuda.ptr(xyz1), _cuda.ptr(v), _cuda.ptr(boxes), b, n, r, int(s),
            _cuda.ptr(idx), _cuda.ptr(cnt), _cuda.ptr(local), *extra,
        )
    return idx, cnt, local


def query_box_group(boxes, s: int, xyz1, valid1=None, *, impl: str = "auto", select=None):
    """``boxes (B,R,6)`` [lo, hi], ``xyz1 (B,N,3)`` -> ``(idx (B,R,S)
    int32, cnt (B,R) int32, local (B,R,S,3) f32)`` with ``local ==
    xyz1[idx] - (lo + hi) / 2`` bit for bit; ``select`` "first" (default)
    or "strided"."""
    return _box_group_op(boxes, xyz1, valid1, int(s), check_select(select), impl)


@gspn_op("box_group")
def _box_group_op(boxes: torch.Tensor, xyz1: torch.Tensor, valid1: torch.Tensor | None, s: int,
                  select: str, impl: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`query_box_group` as one opaque op."""
    if resolve_impl(impl, xyz1) == "cuda":
        if select == "strided":
            return _box_group_strided_cuda(boxes, s, xyz1, valid1)
        return _box_group_cuda(KERNEL, boxes, s, xyz1, valid1, 0)
    return _box_group_plain(boxes, s, xyz1, valid1, select)


@torch.library.register_fake(_box_group_op)
def _(boxes, xyz1, valid1, s, select, impl):
    return tuple(scan_outputs_like(boxes, s, True))


def _box_group_strided_cuda(boxes, s, xyz1, valid1=None, plan=None):
    """The strided kernel at :func:`strided_plan`'s plan, or at ``plan`` =
    (split, direct) to time one plan against another."""
    split, direct, ballots = strided_plan(boxes.shape[0] * boxes.shape[1], 1, xyz1.shape[1],
                                          xyz1.device, plan)
    return _box_group_cuda(STRIDED_KERNEL, boxes, s, xyz1, valid1, split, int(direct),
                           _cuda.ptr(ballots))
