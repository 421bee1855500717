"""Three-nearest-neighbor search and inverse-distance interpolation.

Counterpart of ``gspn_tpu/ops/interpolate.py``: ``three_nn`` (CUDA route
``csrc/three_nn.cu``; plain route the XLA ``top_k`` branch), and the exact
``three_interpolate_weights`` / ``three_interpolate`` (the FP modules' exact
interpolation; the TPU's MXU form ``three_interpolate_mm`` is not ported).
"""

from __future__ import annotations

import torch

from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.ops.common import masked_sqdist, resolve_impl
from gspn_tpu_torch.ops.grouping import group_point

KERNEL = _cuda.KERNELS["three_nn"]


def _three_nn_plain(xyz1, xyz2, valid2):
    """Masked squared distances, then three first-occurrence argmins: the
    (distance, index)-lexicographic top 3, like ``lax.top_k(-d2, 3)``."""
    d2 = masked_sqdist(xyz1, xyz2, valid2)  # (B, N, M)
    work = d2.clone()
    idx = []
    for _ in range(3):
        i = work.argmin(dim=-1, keepdim=True)
        idx.append(i)
        work.scatter_(-1, i, float("inf"))
    idx = torch.cat(idx, dim=-1)
    return torch.gather(d2, -1, idx), idx.to(torch.int32)


def _three_nn_cuda(xyz1, xyz2, valid2):
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    xyz1 = xyz1.contiguous()
    xyz2 = xyz2.contiguous()
    _cuda.check_cuda_input("xyz1", xyz1, torch.float32, (b, n, 3))
    _cuda.check_cuda_input("xyz2", xyz2, torch.float32, (b, m, 3))
    v = None
    if valid2 is not None:
        v = valid2.to(torch.uint8).contiguous()
        _cuda.check_cuda_input("valid2", v, torch.uint8, (b, m))
    dist = torch.empty((b, n, 3), dtype=torch.float32, device=xyz1.device)
    idx = torch.empty((b, n, 3), dtype=torch.int32, device=xyz1.device)
    if b and n:
        KERNEL.launch(
            xyz1.device, _cuda.ptr(xyz1), _cuda.ptr(xyz2), _cuda.ptr(v), b, n, m,
            _cuda.ptr(dist), _cuda.ptr(idx),
        )
    return dist, idx


def three_nn(xyz1, xyz2, valid2=None, *, impl: str = "auto"):
    """3 nearest sources per target: ``xyz1 (B,N,3)`` targets, ``xyz2
    (B,M,3)`` sources -> ``dist (B,N,3)`` squared, ascending, and ``idx
    (B,N,3)`` int32; ties to the lower index; invalid sources rank at
    distance 1e10."""
    if xyz2.shape[1] < 3:
        raise ValueError(f"three_nn needs at least 3 sources, got M={xyz2.shape[1]}")
    if resolve_impl(impl, xyz1) == "cuda":
        return _three_nn_cuda(xyz1, xyz2, valid2)
    return _three_nn_plain(xyz1, xyz2, valid2)


def three_interpolate_weights(dist: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Inverse-distance weights ``(1/d) / sum(1/d)``, ``d = max(dist, eps)``."""
    d = torch.clamp(dist, min=eps)
    recip = torch.ones_like(d) / d  # a true division, not reciprocal * 1.0
    return recip / (recip[..., 0:1] + recip[..., 1:2] + recip[..., 2:3])


def three_interpolate(points, idx, weight) -> torch.Tensor:
    """``(B,M,C), (B,N,3) int, (B,N,3) -> (B,N,C)``: the weighted sum over
    the 3 neighbors in neighbor order (the reference-exact form)."""
    g = group_point(points, idx)  # (B, N, 3, C)
    w = weight[..., None]
    return g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1] + g[:, :, 2] * w[:, :, 2]
