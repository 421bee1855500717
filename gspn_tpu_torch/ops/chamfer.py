"""Bidirectional nearest-neighbour (chamfer) distance: ``nn_distance``.

Counterpart of ``gspn_tpu/ops/chamfer.py``. The argmin indices come from a
non-differentiable search (CUDA route ``csrc/chamfer.cu``, plain route a
masked distance matrix and ``argmin``) on detached inputs, and the
distances are recomputed as a differentiable gather,
``((xyz1 - xyz2[idx1])**2).sum(-1)``, so autograd gives the reference's
analytic gradients (2(x - y) into ``xyz1``, the negated scatter-add into
``xyz2``) with no custom backward.
"""

from __future__ import annotations

import torch

from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.ops.common import masked_sqdist, resolve_impl, sqdist_components
from gspn_tpu_torch.ops.grouping import gather_point

KERNEL = _cuda.KERNELS["nn_argmin"]


def _argmin_plain(a, b, b_valid):
    """Masked squared distances, first-occurrence argmin: padded sources
    count as 1e10, ties go to the lowest index."""
    return masked_sqdist(a, b, b_valid).argmin(dim=-1).to(torch.int32)


def _argmin_cuda(a, b, b_valid):
    bsz, n, _ = a.shape
    m = b.shape[1]
    a = a.contiguous()
    b = b.contiguous()
    _cuda.check_cuda_input("xyz1", a, torch.float32, (bsz, n, 3))
    _cuda.check_cuda_input("xyz2", b, torch.float32, (bsz, m, 3))
    v = None
    if b_valid is not None:
        v = b_valid.to(torch.uint8).contiguous()
        _cuda.check_cuda_input("valid2", v, torch.uint8, (bsz, m))
    idx = torch.empty((bsz, n), dtype=torch.int32, device=a.device)
    if bsz and n:
        KERNEL.launch(a.device, _cuda.ptr(a), _cuda.ptr(b), _cuda.ptr(v), bsz, n, m, _cuda.ptr(idx))
    return idx


def nn_argmin(xyz1, xyz2, valid2=None, *, impl: str = "auto") -> torch.Tensor:
    """Index of the nearest valid ``xyz2 (B,M,3)`` point for every ``xyz1
    (B,N,3)`` point, ``(B, N)`` int32, by squared distance; padded sources
    (``valid2 (B,M)`` False) count as 1e10, ties go to the lowest index.
    Not differentiable."""
    if xyz2.shape[1] == 0:
        raise ValueError("nn_argmin needs at least one source point")
    if resolve_impl(impl, xyz1) == "cuda":
        return _argmin_cuda(xyz1, xyz2, valid2)
    return _argmin_plain(xyz1, xyz2, valid2)


def nn_distance(xyz1, xyz2, valid1=None, valid2=None, *, impl: str = "auto"):
    """Bidirectional nearest-neighbour squared distances ``(dist1 (B,N),
    idx1 (B,N) int32, dist2 (B,M), idx2 (B,M) int32)``. Distances are
    differentiable in both point sets, indices are not. Rows whose own
    point is padded still get values; mask them at the loss."""
    a, b = xyz1.detach(), xyz2.detach()
    idx1 = nn_argmin(a, b, valid2, impl=impl)
    idx2 = nn_argmin(b, a, valid1, impl=impl)
    d1 = xyz1 - gather_point(xyz2, idx1)
    d2 = xyz2 - gather_point(xyz1, idx2)
    dist1 = sqdist_components(d1[..., 0], d1[..., 1], d1[..., 2])
    dist2 = sqdist_components(d2[..., 0], d2[..., 1], d2[..., 2])
    return dist1, idx1, dist2, idx2


def chamfer_loss(pred, target, target_valid=None, *, impl: str = "auto"):
    """Symmetric chamfer loss: the mean over predicted points of ``dist1``
    plus the mean over valid target points of ``dist2``, averaged over the
    batch. Returns a scalar."""
    d1, _, d2, _ = nn_distance(pred, target, valid2=target_valid, impl=impl)
    l1 = d1.mean(dim=-1)
    if target_valid is not None:
        w = target_valid.to(d2.dtype)
        l2 = (d2 * w).sum(dim=-1) / torch.clamp(w.sum(dim=-1), min=1.0)
    else:
        l2 = d2.mean(dim=-1)
    return (l1 + l2).mean()
