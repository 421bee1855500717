"""Three-nearest-neighbor search and inverse-distance interpolation.

Counterpart of ``gspn_tpu/ops/interpolate.py``:

- ``three_nn``: CUDA route ``csrc/three_nn.cu`` at every source count (a
  running top-3 over sources staged through shared memory, the algorithm
  of both TPU kernels, single-shot and tiled-M; ``three_nn_plan`` picks the
  targets a thread, the source slices and the group size); plain route the
  XLA ``top_k`` branch, taken over chunks of targets at large sizes.
- ``three_interpolate_weights`` / ``three_interpolate``: the exact,
  neighbor-ordered interpolation.
- ``three_interpolate_mm``: the interpolation on the kernel path (the
  TPU's MXU kernel), the same neighbor-ordered sum; CUDA route
  ``csrc/interp_mm.cu``.
- ``three_interpolate_fp``: the FP modules' kernel path, the weights, the
  interpolation and the skip concat in one launch of the same kernel
  (``interp_mm_plan`` picks its tiling).
"""

from __future__ import annotations

import torch

from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.ops.common import gspn_op, masked_sqdist, resolve_impl
from gspn_tpu_torch.ops.grouping import group_point, index_add_rows

KERNEL = _cuda.KERNELS["three_nn"]
MM_KERNEL = _cuda.KERNELS["interp_mm"]

# (target, source) distances one plain chunk holds: 256 MB of float32
_PLAIN_PAIRS = 1 << 26
# three_nn_plan, fitted to every (targets a thread, slices, group) timed at
# the main path's and the grid RoIs' shapes on an H100 (PERF.md, section 6): 4
# targets a thread from THREE_NN_PER4_TARGETS targets, else 1; slices while
# the warps stay under THREE_NN_FULL_WARPS (~4 on each of the card's 528
# schedulers) or each slice keeps THREE_NN_LONG_SLICE sources, never below
# THREE_NN_MIN_SLICE sources a slice; groups of 32 sources where a slice
# keeps THREE_NN_GROUP32_SLICE, else each source inserted as it comes
THREE_NN_PER4_TARGETS = 1 << 19
THREE_NN_FULL_WARPS = 2048
THREE_NN_MAX_SPLIT = 32
THREE_NN_MIN_SLICE = 32
THREE_NN_LONG_SLICE = 2048
THREE_NN_GROUP32_SLICE = 512


def three_nn_plan(b: int, n: int, m: int) -> tuple[int, int, int]:
    """``(targets a thread, source slices, sources a group)`` for the kernel
    at ``b`` scenes of ``n`` targets and ``m`` sources. More targets a
    thread share each source load but insert more often (a warp inserts
    whenever one of its targets does); more slices fill the card when
    targets are few, but each slice starts its top 3 afresh (more
    insertions) and the slices' lists are merged by (distance, index) at
    the end; a group of 32 sources compared before inserting wastes less
    where a slice is long, and a group of 1 where it is short."""
    targets = b * n
    per = 4 if targets >= THREE_NN_PER4_TARGETS else 1
    warps = -(-targets // (32 * per))
    split = 1
    while (split < THREE_NN_MAX_SPLIT and m // (split * 2) >= THREE_NN_MIN_SLICE
           and (warps * split < THREE_NN_FULL_WARPS
                or m // (split * 2) >= THREE_NN_LONG_SLICE)):
        split *= 2
    return per, split, 32 if m // split >= THREE_NN_GROUP32_SLICE else 1


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


def _three_nn_cuda(xyz1, xyz2, valid2, plan=None):
    """The kernel at ``three_nn_plan``'s choice, or at ``plan`` = (targets
    a thread, source slices, sources a group) to time one against
    another."""
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    xyz1 = xyz1.contiguous()
    xyz2 = xyz2.contiguous()
    _cuda.check_cuda_input("xyz1", xyz1, torch.float32, (b, n, 3))
    _cuda.check_cuda_input("xyz2", xyz2, torch.float32, (b, m, 3))
    v = None
    if valid2 is not None:
        v = _cuda.flag_bytes(valid2)
        _cuda.check_cuda_input("valid2", v, torch.uint8, (b, m))
    per, split, group = plan or three_nn_plan(b, n, m)
    dist = torch.empty((b, n, 3), dtype=torch.float32, device=xyz1.device)
    idx = torch.empty((b, n, 3), dtype=torch.int32, device=xyz1.device)
    if b and n:
        KERNEL.launch(
            xyz1.device, _cuda.ptr(xyz1), _cuda.ptr(xyz2), _cuda.ptr(v), b, n, m, per, split,
            group, _cuda.ptr(dist), _cuda.ptr(idx),
        )
    return dist, idx


def three_nn(xyz1, xyz2, valid2=None, *, impl: str = "auto"):
    """3 nearest sources per target: ``xyz1 (B,N,3)`` targets, ``xyz2
    (B,M,3)`` sources -> ``dist (B,N,3)`` squared, ascending, and ``idx
    (B,N,3)`` int32; ties to the lower index; invalid sources rank at
    distance 1e10."""
    if xyz2.shape[1] < 3:
        raise ValueError(f"three_nn needs at least 3 sources, got M={xyz2.shape[1]}")
    return _three_nn_op(xyz1, xyz2, valid2, impl)


@gspn_op("three_nn")
def _three_nn_op(xyz1: torch.Tensor, xyz2: torch.Tensor, valid2: torch.Tensor | None,
                 impl: str) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`three_nn` as one opaque op."""
    if resolve_impl(impl, xyz1) == "cuda":
        return _three_nn_cuda(xyz1, xyz2, valid2)
    return _three_nn_plain(xyz1, xyz2, valid2)


@torch.library.register_fake(_three_nn_op)
def _(xyz1, xyz2, valid2, impl):
    shape = (*xyz1.shape[:2], 3)
    return xyz1.new_empty(shape), xyz1.new_empty(shape, dtype=torch.int32)


def three_interpolate_weights(dist: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Inverse-distance weights ``(1/d) / sum(1/d)``, ``d = max(dist, eps)``."""
    d = torch.clamp(dist, min=eps)
    recip = torch.ones_like(d) / d  # a true division, not reciprocal * 1.0
    return recip / (recip[..., 0:1] + recip[..., 1:2] + recip[..., 2:3])


def three_interpolate(points, idx, weight, *, impl: str = "auto") -> torch.Tensor:
    """``(B,M,C), (B,N,3) int, (B,N,3) -> (B,N,C)``: the weighted sum over
    the 3 neighbors in neighbor order (the reference-exact form). ``impl``
    is the route of the gather's backward (``group_point``): a plain-path
    caller passes "plain", so its backward launches no kernel on the
    card."""
    g = group_point(points, idx, impl=impl)  # (B, N, 3, C)
    w = weight[..., None]
    return g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1] + g[:, :, 2] * w[:, :, 2]


# interp_mm_plan: the warp tasks that keep the card busiest (fitted to every
# (rows, slices) timed at the FP levels' shapes on an H100; PERF.md, section
# 6) and the most rows a warp's task takes (csrc/interp_mm.cu kMaxRows);
# a slice of an output row is a multiple of INTERP_MM_SLICE floats. The
# staged form: slices of INTERP_MM_STAGE channels, chunks of at most
# INTERP_MM_MAX_CHUNK rows (kMaxChunk), a CTA an SM, within a CTA's shared
# memory; taken from INTERP_MM_STAGE_ROWS target rows a scene
INTERP_MM_TASKS = 2048
INTERP_MM_MAX_ROWS = 8
INTERP_MM_SLICE = 128
INTERP_MM_SMS = 132
INTERP_MM_STAGE = 32
INTERP_MM_MAX_CHUNK = 2048
INTERP_MM_STAGE_ROWS = 4096
INTERP_MM_SMEM = 232448


def interp_mm_plan(b: int, n: int, m: int, c: int, c1: int = 0,
                   aligned: bool = True) -> tuple[int, int, int]:
    """``(rows, slices, stage)`` for the kernel over ``b`` scenes of ``n``
    target rows, ``m`` sources of ``c`` channels and ``c1`` skip channels.

    - Staged (``stage`` 32): many rows a scene, no skip, ``c`` a multiple of
      32 and 16-byte aligned sources (``aligned``): a CTA a (scene, slice of
      32 channels, chunk of ``rows`` target rows) stages the scene's slice
      of sources in shared memory, so each source row is read from L2 once
      a CTA rather than three times a target (FP4: 8 x 8192 rows, 4
      slices, 4 chunks of 2048 rows, 128 CTAs).
    - Direct (``stage`` 0): a warp a task of ``rows`` target rows (1-8) and
      one of ``slices`` slices of their output columns, about 2048 tasks:
      few rows are cut into slices (FP1: 512 rows of 768 in 4), many rows
      grouped so that a warp's one load of indices and distances serves up
      to 8 (FP3: 8192 rows in tasks of 4)."""
    if c1 == 0 and aligned and c % INTERP_MM_STAGE == 0 and n >= INTERP_MM_STAGE_ROWS:
        slices = c // INTERP_MM_STAGE
        chunks = max(1, INTERP_MM_SMS // (b * slices))
        chunk = min(-(-n // chunks), INTERP_MM_MAX_CHUNK)
        if m * INTERP_MM_STAGE * 4 + chunk * 32 <= INTERP_MM_SMEM:
            return chunk, slices, INTERP_MM_STAGE
    rows, width = b * n, c + c1
    chunks = max(1, -(-width // INTERP_MM_SLICE))
    slices = min(chunks, max(1, -(-INTERP_MM_TASKS // max(rows, 1))))
    per = min(INTERP_MM_MAX_ROWS, max(1, rows * slices // INTERP_MM_TASKS))
    return per, slices, 0


def _interp_mm_cuda(points, idx, wd, skip=None, *, from_dist=False, plan=None):
    """The kernel: ``wd`` holds the weights, or three_nn's squared distances
    when ``from_dist``; ``skip (B,N,C1)`` rows follow the interpolated
    channels; at ``interp_mm_plan``'s choice or at ``plan``."""
    b, m, c = points.shape
    n = idx.shape[1]
    points = points.contiguous()
    idx = idx.to(torch.int32).contiguous()
    wd = wd.contiguous()
    _cuda.check_cuda_input("points", points, torch.float32, (b, m, c))
    _cuda.check_cuda_input("idx", idx, torch.int32, (b, n, 3))
    _cuda.check_cuda_input("dist" if from_dist else "weight", wd, torch.float32, (b, n, 3))
    c1 = 0
    if skip is not None:
        skip = skip.contiguous()
        c1 = skip.shape[-1]
        _cuda.check_cuda_input("points1", skip, torch.float32, (b, n, c1))
    out = torch.empty((b, n, c + c1), dtype=torch.float32, device=points.device)
    rows, slices, stage = plan or interp_mm_plan(b, n, m, c, c1, points.data_ptr() % 16 == 0)
    if b and n and c + c1:
        MM_KERNEL.launch(
            points.device, _cuda.ptr(points), _cuda.ptr(idx), _cuda.ptr(wd), int(from_dist),
            _cuda.ptr(skip), b, n, m, c, c1, rows, slices, stage, _cuda.ptr(out),
        )
    return out


def _interp_grads(points, idx, weight, g, impl):
    """The exact scatter-add / inner-product pair of the JAX package's
    ``_mm_bwd`` (gspn_tpu/ops/interpolate.py:431-447): ``(dpoints,
    dweight)``, the scatter-add through the deterministic
    ``index_add_rows`` (in (target, neighbor) order)."""
    dpoints = _interp_dpoints(idx, weight, g, points.shape[1], impl)
    dweight = _interp_dweight(points, idx, g)
    return dpoints.to(points.dtype), dweight.to(weight.dtype)


def _interp_dpoints(idx, weight, g, m, impl):
    b, n, _ = idx.shape
    contrib = (weight[..., None] * g[..., None, :]).reshape(b, n * 3, g.shape[-1])
    return index_add_rows(contrib, idx.reshape(b, n * 3), m, impl=impl)


def _interp_dweight(points, idx, g):
    return (group_point(points, idx) * g[..., None, :]).sum(-1)


@gspn_op("three_interpolate_mm")
def _interp_mm_op(points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
                  impl: str) -> torch.Tensor:
    """:func:`three_interpolate_mm` as one opaque op: the kernel (or its
    plain version); backward ``_interp_grads``."""
    if resolve_impl(impl, points) == "cuda":
        return _interp_mm_cuda(points, idx, weight)
    return three_interpolate(points, idx, weight, impl=impl)


@torch.library.register_fake(_interp_mm_op)
def _(points, idx, weight, impl):
    return points.new_empty((*idx.shape[:2], points.shape[-1]))


def _save_inputs(ctx, inputs, output):
    """Saves the tensors before the op's last argument, ``impl``."""
    ctx.save_for_backward(*inputs[:-1])
    ctx.impl = inputs[-1]


def _interp_mm_backward(ctx, g):
    points, idx, weight = ctx.saved_tensors
    dpoints, dweight = _interp_grads(points, idx, weight, g, ctx.impl)
    return dpoints, None, dweight, None


torch.library.register_autograd(_interp_mm_op, _interp_mm_backward, setup_context=_save_inputs)


def three_interpolate_mm(points, idx, weight, *, impl: str = "auto") -> torch.Tensor:
    """:func:`three_interpolate` on the FP modules' kernel path: the CUDA
    kernel sums in neighbor order, bitwise the plain version, where the
    TPU's sparse-matmul kernel sums in source order (within 1-2 ulp). The
    JAX package falls back to the exact form above the TPU kernel's 8 MB
    source block; here every size launches the kernel, with the same
    result. ``idx`` must lie in ``[0, M)``. Differentiable in ``points``
    and ``weight``."""
    return _interp_mm_op(points, idx, weight, impl)


def _interpolate_fp_plain(points2, idx, dist, points1, impl="plain"):
    out = three_interpolate(points2, idx, three_interpolate_weights(dist), impl=impl)
    return out if points1 is None else torch.cat([out, points1], dim=-1)


@gspn_op("three_interpolate_fp")
def _interp_fp_op(points2: torch.Tensor, idx: torch.Tensor, dist: torch.Tensor,
                  points1: torch.Tensor | None, impl: str) -> torch.Tensor:
    """:func:`three_interpolate_fp` as one opaque op: the kernel from the
    distances (or its plain version); backward ``_interp_fp_backward``."""
    if resolve_impl(impl, points2) == "cuda":
        return _interp_mm_cuda(points2, idx, dist, points1, from_dist=True)
    return _interpolate_fp_plain(points2, idx, dist, points1, impl)


@torch.library.register_fake(_interp_fp_op)
def _(points2, idx, dist, points1, impl):
    c1 = 0 if points1 is None else points1.shape[-1]
    return points2.new_empty((*idx.shape[:2], points2.shape[-1] + c1))


def _interp_fp_backward(ctx, g):
    """The weights recomputed from ``dist`` under autograd,
    ``_interp_grads`` on the interpolated columns' gradient, the weights'
    gradient taken back into ``dist``, and the skip columns' gradient
    passed to ``points1``: bitwise autograd through the composite."""
    points2, idx, dist, _ = ctx.saved_tensors
    c2 = points2.shape[-1]
    g2 = g[..., :c2]
    dpoints = ddist = None
    if ctx.needs_input_grad[0] or ctx.needs_input_grad[2]:
        with torch.enable_grad():
            d = dist.detach().requires_grad_(True)
            weight = three_interpolate_weights(d)
    if ctx.needs_input_grad[0]:
        dpoints = _interp_dpoints(idx, weight.detach(), g2, points2.shape[1], ctx.impl)
        dpoints = dpoints.to(points2.dtype)
    if ctx.needs_input_grad[2]:
        dweight = _interp_dweight(points2, idx, g2).to(weight.dtype)
        (ddist,) = torch.autograd.grad(weight, d, dweight)
    dskip = g[..., c2:] if ctx.needs_input_grad[3] else None
    return dpoints, None, ddist, dskip, None


torch.library.register_autograd(_interp_fp_op, _interp_fp_backward, setup_context=_save_inputs)


def three_interpolate_fp(points2, idx, dist, points1=None, *, impl: str = "auto"):
    """An FP module's interpolation and skip concat in one: ``points2
    (B,M,C2)`` sources, ``idx (B,N,3)`` and ``dist (B,N,3)`` from
    :func:`three_nn`, ``points1 (B,N,C1)`` skip features or None -> ``(B,
    N, C2 [+ C1])``, bitwise ``torch.cat([three_interpolate(points2, idx,
    three_interpolate_weights(dist)), points1], -1)``. On the card one
    launch of the ``interp_mm`` kernel computes the weights, the
    neighbor-ordered sum and the concat. Differentiable in ``points2``,
    ``dist`` and ``points1``, with the composite's gradients bit for bit.
    ``idx`` must lie in ``[0, M)``."""
    return _interp_fp_op(points2, idx, dist, points1, impl)
