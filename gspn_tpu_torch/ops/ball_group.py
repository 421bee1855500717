"""Fused multi-radius ball query + group + centre subtract.

Counterpart of ``gspn_tpu/ops/ball_group.py::query_ball_group_multi`` with
``select="first"``. The CUDA route is ``csrc/ball_group.cu`` (one warp per
query, one shared distance for all concentric scales, early exit); the
plain route is the ball query plus a ``group_point`` gather.
"""

from __future__ import annotations

import ctypes

import torch

from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.ops.ball_query import ball_query_plain
from gspn_tpu_torch.ops.common import resolve_impl
from gspn_tpu_torch.ops.grouping import group_point

KERNEL = _cuda.KERNELS["ball_group"]
MAX_SCALES = 4  # csrc/group_scan.cuh kMaxScales


def check_select(select: str | None) -> None:
    if select not in (None, "first"):
        raise NotImplementedError(
            f"group_select={select!r} is not ported; only 'first' is "
            '(ROADMAP.md, "Knob paths" and "_fused_kernel_strided")'
        )


def _ball_group_plain(radii, nsamples, xyz1, xyz2, valid1):
    out = []
    for r, k in zip(radii, nsamples, strict=True):
        idx, cnt = ball_query_plain(r, k, xyz1, xyz2, valid1)
        local = group_point(xyz1, idx) - xyz2[:, :, None, :]
        out.append((idx, cnt, local))
    return out


def _ball_group_cuda(radii, nsamples, xyz1, xyz2, valid1):
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    s = len(radii)
    if not 1 <= s <= MAX_SCALES:
        raise ValueError(f"ball-group kernel takes 1..{MAX_SCALES} scales, got {s}")
    xyz1 = xyz1.contiguous()
    xyz2 = xyz2.contiguous()
    _cuda.check_cuda_input("xyz1", xyz1, torch.float32, (b, n, 3))
    _cuda.check_cuda_input("xyz2", xyz2, torch.float32, (b, m, 3))
    v = None
    if valid1 is not None:
        v = valid1.to(torch.uint8).contiguous()
        _cuda.check_cuda_input("valid1", v, torch.uint8, (b, n))
    dev = xyz1.device
    outs = [
        (
            torch.empty((b, m, k), dtype=torch.int32, device=dev),
            torch.empty((b, m), dtype=torch.int32, device=dev),
            torch.empty((b, m, k, 3), dtype=torch.float32, device=dev),
        )
        for k in nsamples
    ]
    if b and m:
        # r^2 in Python double, rounded once to f32 (as the JAX package does)
        r2s = (ctypes.c_float * s)(*(float(r) * float(r) for r in radii))
        ks = (ctypes.c_int * s)(*(int(k) for k in nsamples))
        idx_p = (ctypes.c_void_p * s)(*(_cuda.ptr(o[0]) for o in outs))
        cnt_p = (ctypes.c_void_p * s)(*(_cuda.ptr(o[1]) for o in outs))
        loc_p = (ctypes.c_void_p * s)(*(_cuda.ptr(o[2]) for o in outs))
        KERNEL.launch(
            dev, _cuda.ptr(xyz1), _cuda.ptr(v), _cuda.ptr(xyz2), b, n, m, s,
            ctypes.addressof(r2s), ctypes.addressof(ks), ctypes.addressof(idx_p),
            ctypes.addressof(cnt_p), ctypes.addressof(loc_p),
        )
    return outs


def query_ball_group_multi(
    radii, nsamples, xyz1, xyz2, valid1=None, *, impl: str = "auto", select=None
):
    """Per scale ``(idx (B,M,K) int32, cnt (B,M) int32, local (B,M,K,3)
    f32)`` where ``local == group_point(xyz1, idx) - xyz2[:, :, None]``
    bit for bit. ``xyz1 (B,N,3)`` dataset, ``xyz2 (B,M,3)`` query centres,
    ``valid1 (B,N)`` optional."""
    check_select(select)
    if resolve_impl(impl, xyz1) == "cuda":
        return _ball_group_cuda(radii, nsamples, xyz1, xyz2, valid1)
    return _ball_group_plain(radii, nsamples, xyz1, xyz2, valid1)
