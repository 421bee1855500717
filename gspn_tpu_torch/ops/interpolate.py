"""Three-nearest-neighbor search and inverse-distance interpolation.

Counterpart of ``gspn_tpu/ops/interpolate.py``:

- ``three_nn``: CUDA route ``csrc/three_nn.cu`` at every source count (it
  streams sources through shared memory with a running top-3, the
  algorithm of both TPU kernels, single-shot and tiled-M); plain route the
  XLA ``top_k`` branch, taken over chunks of targets at large sizes.
- ``three_interpolate_weights`` / ``three_interpolate``: the exact,
  neighbor-ordered interpolation.
- ``three_interpolate_mm``: the FP modules' interpolation on the kernel
  path (the TPU's MXU kernel), the same neighbor-ordered sum; CUDA route
  ``csrc/interp_mm.cu``.
"""

from __future__ import annotations

import torch

from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.ops.common import masked_sqdist, resolve_impl
from gspn_tpu_torch.ops.grouping import group_point, index_add_rows

KERNEL = _cuda.KERNELS["three_nn"]
MM_KERNEL = _cuda.KERNELS["interp_mm"]

# (target, source) distances one plain chunk holds: 256 MB of float32
_PLAIN_PAIRS = 1 << 26


def _three_nn_dense(xyz1, xyz2, valid2):
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


def _three_nn_plain(xyz1, xyz2, valid2):
    """``_three_nn_dense`` over chunks of targets, so the (B, N, M) distance
    matrix of a whole scene is never held at once; targets are independent,
    so the result is the same."""
    b, n, _ = xyz1.shape
    step = max(1, _PLAIN_PAIRS // max(1, b * xyz2.shape[1]))
    if n <= step:
        return _three_nn_dense(xyz1, xyz2, valid2)
    parts = [_three_nn_dense(xyz1[:, i:i + step], xyz2, valid2) for i in range(0, n, step)]
    return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)


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


def _interp_mm_cuda(points, idx, weight):
    b, m, c = points.shape
    n = idx.shape[1]
    points = points.contiguous()
    idx = idx.to(torch.int32).contiguous()
    weight = weight.contiguous()
    _cuda.check_cuda_input("points", points, torch.float32, (b, m, c))
    _cuda.check_cuda_input("idx", idx, torch.int32, (b, n, 3))
    _cuda.check_cuda_input("weight", weight, torch.float32, (b, n, 3))
    out = torch.empty((b, n, c), dtype=torch.float32, device=points.device)
    if b and n and c:
        MM_KERNEL.launch(
            points.device, _cuda.ptr(points), _cuda.ptr(idx), _cuda.ptr(weight), b, n, m, c,
            _cuda.ptr(out),
        )
    return out


class _InterpolateMM(torch.autograd.Function):
    """Forward: the kernel (or its plain version); backward: the exact
    scatter-add / inner-product pair of the JAX package's ``_mm_bwd``
    (gspn_tpu/ops/interpolate.py:431-447), the scatter-add through the
    deterministic ``index_add_rows`` (in (target, neighbor) order)."""

    @staticmethod
    def forward(ctx, points, idx, weight, impl):
        ctx.save_for_backward(points, idx, weight)
        ctx.impl = impl
        if resolve_impl(impl, points) == "cuda":
            return _interp_mm_cuda(points, idx, weight)
        return three_interpolate(points, idx, weight)

    @staticmethod
    def backward(ctx, g):
        points, idx, weight = ctx.saved_tensors
        b, n, _ = idx.shape
        m, c = points.shape[1:]
        contrib = (weight[..., None] * g[..., None, :]).reshape(b, n * 3, c)
        dpoints = index_add_rows(contrib, idx.reshape(b, n * 3), m, impl=ctx.impl)
        dweight = (group_point(points, idx) * g[..., None, :]).sum(-1)
        return dpoints.to(points.dtype), None, dweight.to(weight.dtype), None


def three_interpolate_mm(points, idx, weight, *, impl: str = "auto") -> torch.Tensor:
    """:func:`three_interpolate` on the FP modules' kernel path: the CUDA
    kernel sums in neighbor order, bitwise the plain version, where the
    TPU's sparse-matmul kernel sums in source order (within 1-2 ulp). The
    JAX package falls back to the exact form above the TPU kernel's 8 MB
    source block; here every size launches the kernel, with the same
    result. ``idx`` must lie in ``[0, M)``. Differentiable in ``points``
    and ``weight``."""
    return _InterpolateMM.apply(points, idx, weight, impl)
