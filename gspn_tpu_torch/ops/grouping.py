"""Index-gather ops: ``gather_point`` and ``group_point``, and their
deterministic adjoint ``index_add_rows``.

Counterparts of ``gspn_tpu/ops/grouping.py``. Indices are int32 at the
public surface (as in the JAX package); torch gathers need int64, so they
are widened here, at the point of use.

The forward is ``torch.gather``, as the JAX package gathers outside any
Pallas kernel. The backward is :func:`index_add_rows`, which adds each
output row's incoming rows in ascending source position from +0.0, as the
CPU's ``scatter_add`` does: on the card ``torch.gather``'s own backward adds
with atomics in no fixed order, so a training step would not be bitwise
reproducible. ``impl`` picks the backward's route (``ops/common.py``): the
CUDA kernel ``csrc/index_add.cu`` (one launch: a stable counting sort of
each list of kept positions and the sums, in the kernel, at
:func:`index_add_plan`'s tiling) or its plain version, bitwise equal.
"""

from __future__ import annotations

import functools

import torch

from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.ops.common import gspn_op, resolve_impl

KERNEL = _cuda.KERNELS["index_add"]
# the kernel's limits (csrc/index_add.cu): output rows a CTA (kMaxBins), a
# CTA's running sums (kAccFloats)
INDEX_ADD_MAX_BINS = 256
INDEX_ADD_ACC_FLOATS = 8192
# index_add_plan narrows the row tiles while a launch has fewer CTAs than
# this (two a streaming multiprocessor on an H100's 132, rounded)
INDEX_ADD_TARGET_CTAS = 256


def _index_add_plain(src: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch in the kernel's order: a stable sort of each row's
    indices, each position's rank within its run, then one add per rank,
    so every output row sums its terms in ascending position. The
    positions are grouped by rank once (one host sync), so each add is a
    slice."""
    b, m, c = src.shape
    out = torch.zeros((b, n, c), dtype=src.dtype, device=src.device)
    if not (b and m):
        return out
    sidx, perm = torch.sort(idx.long(), dim=1, stable=True)
    rank = (torch.arange(m, device=src.device) - torch.searchsorted(sidx, sidx)).reshape(-1)
    by_rank = torch.sort(rank, stable=True).indices
    rows = torch.arange(b, device=src.device).repeat_interleave(m)[by_rank]
    cols = sidx.reshape(-1)[by_rank]
    terms = torch.gather(src, 1, perm[..., None].expand(b, m, c)).reshape(b * m, c)[by_rank]
    start = 0
    for count in torch.bincount(rank).tolist():
        at = slice(start, start + count)  # at most one position per (row, index)
        out[rows[at], cols[at]] = out[rows[at], cols[at]] + terms[at]
        start += count
    return out


@functools.lru_cache(maxsize=256)
def index_add_plan(b: int, n: int, c: int) -> tuple[int, int]:
    """``(bins, tile_c)`` of the index_add kernel for ``src (b, m, c)`` into
    ``n`` rows: a CTA's channels (all C up to ``INDEX_ADD_ACC_FLOATS``)
    and its output rows (as many as its sums hold, up to
    ``INDEX_ADD_MAX_BINS``), halved while the launch has fewer than
    ``INDEX_ADD_TARGET_CTAS`` CTAs and a batch row's CTAs stay within C:
    each CTA reads the batch row's M indices, so the index bytes read stay
    within the source's."""
    tile_c = max(1, min(c, INDEX_ADD_ACC_FLOATS))
    bins = max(1, min(n, INDEX_ADD_MAX_BINS, INDEX_ADD_ACC_FLOATS // tile_c))
    ctas = lambda bins: -(-n // bins) * -(-c // tile_c)  # noqa: E731 (a batch row's)
    while bins > 1 and b * ctas(bins) < INDEX_ADD_TARGET_CTAS and ctas(bins // 2) <= c:
        bins //= 2
    return bins, tile_c


def _index_add_cuda(src: torch.Tensor, idx: torch.Tensor, n: int, plan=None) -> torch.Tensor:
    """The kernel at :func:`index_add_plan`'s plan, or at ``plan`` =
    (bins, tile_c) to time or test another tiling."""
    b, m, c = src.shape
    if b > 65535:
        raise ValueError(f"the index_add kernel takes at most 65535 rows, got {b}")
    src = src.contiguous()
    _cuda.check_cuda_input("src", src, torch.float32, src.shape)
    if idx.dtype != torch.int32:
        idx = idx.to(torch.int32)
    idx = idx.contiguous()
    _cuda.check_cuda_input("idx", idx, torch.int32, (b, m))
    out = src.new_empty((b, n, c))
    if b and n and c:
        bins, tile_c = plan or index_add_plan(b, n, c)
        KERNEL.launch(src.device, src.data_ptr(), idx.data_ptr(), b, m, n, c, bins, tile_c,
                      out.data_ptr())
    return out


def index_add_rows(src: torch.Tensor, idx: torch.Tensor, n: int, *,
                   impl: str = "auto") -> torch.Tensor:
    """``out (B, n, C)`` with ``out[b, idx[b, p]] += src[b, p]`` for ``src
    (B, M, C)`` and ``idx (B, M)`` in ``[0, n)``: each output row sums its
    terms in ascending ``p`` from +0.0, so the result is the same on every
    run and route."""
    return _index_add_op(src, idx, int(n), impl)


@gspn_op("index_add_rows")
def _index_add_op(src: torch.Tensor, idx: torch.Tensor, n: int, impl: str) -> torch.Tensor:
    """:func:`index_add_rows` as one opaque op."""
    if resolve_impl(impl, src) == "cuda":
        return _index_add_cuda(src, idx, n)
    return _index_add_plain(src, idx, n)


@torch.library.register_fake(_index_add_op)
def _(src, idx, n, impl):
    return src.new_empty((src.shape[0], n, src.shape[-1]))


def _gather_rows(inp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(inp, -2, idx.long()[..., None].expand(*idx.shape, inp.shape[-1]))


class _GatherRows(torch.autograd.Function):
    """``torch.gather`` of rows forward, :func:`index_add_rows` backward."""

    @staticmethod
    def forward(ctx, inp, idx, impl):
        ctx.save_for_backward(idx)
        ctx.n, ctx.impl = inp.shape[-2], impl
        return _gather_rows(inp, idx)

    @staticmethod
    def backward(ctx, g):
        """A bfloat16 gradient (of a bfloat16 MLP's gather) is summed in
        float32, as the kernel takes it, and rounded once."""
        (idx,) = ctx.saved_tensors
        return index_add_rows(g.float(), idx, ctx.n, impl=ctx.impl).to(g.dtype), None, None


def gather_point(inp: torch.Tensor, idx: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """``(B, N, C), (B, M) int -> (B, M, C)``; differentiable in ``inp``
    through the deterministic :func:`index_add_rows`."""
    if torch.is_grad_enabled() and inp.requires_grad:
        return _GatherRows.apply(inp, idx, impl)
    return _gather_rows(inp, idx)  # no graph: skip the autograd.Function's host work


def group_point(points: torch.Tensor, idx: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """``(B, N, C), (B, M, K) int -> (B, M, K, C)``."""
    b, _, c = points.shape
    m, k = idx.shape[-2:]
    flat = gather_point(points, idx.reshape(b, m * k), impl=impl)
    return flat.reshape(b, m, k, c)
