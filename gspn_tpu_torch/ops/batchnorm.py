"""BatchNorm in training mode with its ReLU, forward and backward, on four
hand-written kernels (``csrc/batchnorm.cu``, namespace ``gspn_bn``) around
PyTorch's column sums, bitwise ``nn/layers.py``'s ``MaskedBatchNorm`` code
and its autograd backward.

``MaskedBatchNorm`` takes this path for a CUDA tensor in training mode
without cross-rank statistics (:func:`batch_norm_train`). The module's
code is a chain of ~28 element-wise and reduction kernels forward and ~18
backward a layer. Here the column sums stay PyTorch's reductions over the
same tensors, so they round as the module's do (the training steps'
losses, gradients and running statistics are the same bits on either
path), and the kernels do the rest, each step rounded in the module's
order:

- :func:`batch_norm_stats` (kernel ``bn_stats``): the sums of ``x`` and
  ``x * x`` (weighted by ``mask``), then in one launch the batch's mean,
  ``rstd`` and the blend of the running statistics, in place.
- :func:`batch_norm_apply` (``bn_apply``): ``((x - mean) * rstd) * scale +
  bias``, the ReLU and the cast to the output dtype, one pass.
- :func:`batch_norm_grad_terms` (``bn_grad_terms``): the ReLU's gradient
  and the three products whose column sums autograd takes (the scale's,
  ``rstd``'s and the mean's), one pass; their sums are PyTorch's.
- :func:`batch_norm_grad_input` (``bn_grad_input``): from those sums, the
  gradients of the variance and the mean, then ``dx``, one pass.

:func:`batch_norm_train` is the two forward steps under one
``torch.autograd.Function`` whose backward is the other two, all four
plain functions: no ``gspn::`` op, since only the training step calls
them and ``torch.export`` traces eval mode, which never takes this path
(``torch.library.register_autograd`` also takes no op that mutates an
input, the running statistics). Every function takes
``impl="auto|cuda|plain"`` (``ops/common.py``); each kernel counts its
launches in ``KERNELS[name].launches``.
"""

from __future__ import annotations

import functools

import torch

from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.ops.common import resolve_impl

STATS_KERNEL = _cuda.KERNELS["bn_stats"]
APPLY_KERNEL = _cuda.KERNELS["bn_apply"]
TERMS_KERNEL = _cuda.KERNELS["bn_grad_terms"]
INPUT_KERNEL = _cuda.KERNELS["bn_grad_input"]

# the element-wise kernels' layout (csrc/batchnorm.cu kThreads, kLanes,
# kUnroll) and batch_norm_plan's target: eight CTAs on each of an H100's 132
# streaming multiprocessors
BN_THREADS = 256
BN_LANES = 32
BN_UNROLL = 4
BN_CTAS = 8 * 132


@functools.lru_cache(maxsize=1024)
def batch_norm_plan(rows: int, c: int) -> int:
    """CTAs along the rows of an ``(rows, c)`` pass: each CTA takes 256 /
    lanes rows at a time (a lane a vector of 4 channels, up to 32 lanes;
    the channel tiles are the grid's other axis), a thread at least 4 rows,
    about ``BN_CTAS`` CTAs in all."""
    v = 4 if c % 4 == 0 else 1
    lanes = max(1, min(c // v, BN_LANES))
    tiles = -(-(c // v) // lanes)
    groups = max(1, -(-rows // (BN_THREADS // lanes)))
    return max(1, min(-(-groups // BN_UNROLL), BN_CTAS // tiles))


def _row_weights(mask: torch.Tensor | None, rows: int):
    """``(tensor or None, kind)``: the kernels' row weights, none (0), a
    bool mask as one byte a row (1, no copy) or float32 (2)."""
    if mask is None:
        return None, 0
    if mask.dtype == torch.bool:
        w = _cuda.flag_bytes(mask.reshape(rows))
        _cuda.check_cuda_input("mask", w, torch.uint8, (rows,))
        return w, 1
    w = mask.reshape(rows).to(torch.float32).contiguous()
    _cuda.check_cuda_input("mask", w, torch.float32, (rows,))
    return w, 2


def _input(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    if x.ndim != 2:
        raise ValueError(f"the BatchNorm kernels take an (R, C) input, got {tuple(x.shape)}")
    _cuda.check_cuda_input("x", x, torch.float32, x.shape)
    return x


def _check_params(c: int, stats, scale=None, bias=None) -> None:
    _cuda.check_cuda_input("stats", stats, torch.float32, (3 * c + 1,))
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None:
            _cuda.check_cuda_input(name, t, torch.float32, (c,))


def _split(stats: torch.Tensor, c: int):
    return stats[:c], stats[c:2 * c], stats[2 * c:3 * c], stats[3 * c]


# ---------------------------------------------------------------- statistics


def _column_sums(x, mask):
    """The module's sums, as it takes them: ``(sum(x), sum(x * x), None)``,
    or with the weights ``w`` of ``mask``, ``(sum(x * w), sum(x * x * w),
    sum(w))``."""
    if mask is None:
        return x.sum(dim=0), (x * x).sum(dim=0), None
    w = mask.reshape(x.shape[0]).to(x.dtype)[:, None]
    return (x * w).sum(dim=0), (x * x * w).sum(dim=0), w.sum()


def _stats_plain(x, mask, running_mean, running_var, eps, momentum, update):
    """The module's statistics (nn/layers.py's code), then ``[mean, rstd,
    gate, tot]``: gate 1 where the variance's clamp passes its gradient
    (``s2 / tot - mean^2 >= 0``)."""
    s1, s2, tot = _column_sums(x, mask)
    if tot is None:
        tot = torch.full((), float(x.shape[0]), dtype=x.dtype, device=x.device)
    tot = torch.clamp(tot, min=1.0)
    mean = s1 / tot
    v = s2 / tot - mean * mean
    var = torch.clamp(v, min=0.0)
    if update:
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean + (1.0 - momentum) * mean)
            running_var.copy_(momentum * running_var + (1.0 - momentum) * var)
    rstd = torch.rsqrt(var + eps)
    return torch.cat([mean, rstd, (v >= 0.0).to(x.dtype), tot.reshape(1)])


def _stats_cuda(x, mask, running_mean, running_var, eps, momentum, update):
    x = _input(x)
    rows, c = x.shape
    if update:
        for name, t in (("running_mean", running_mean), ("running_var", running_var)):
            _cuda.check_cuda_input(name, t, torch.float32, (c,))
    s1, s2, tot = _column_sums(x, mask)
    stats = x.new_empty(3 * c + 1)
    if c:
        STATS_KERNEL.launch(
            x.device, _cuda.ptr(s1), _cuda.ptr(s2), _cuda.ptr(tot), rows, c, float(eps),
            float(momentum), 1.0 - float(momentum), int(update), _cuda.ptr(stats),
            _cuda.ptr(running_mean if update else None), _cuda.ptr(running_var if update else None),
        )
    return stats


def batch_norm_stats(x: torch.Tensor, mask: torch.Tensor | None, running_mean: torch.Tensor,
                     running_var: torch.Tensor, *, eps: float, momentum: float,
                     update: bool = True, impl: str = "auto") -> torch.Tensor:
    """The training statistics of ``x (R, C)`` (no gradient), weighted by
    ``mask (R,)`` when given: ``(3 C + 1,)`` float32 holding the batch mean,
    ``rstd = rsqrt(var + eps)`` with the biased variance ``max(E[x^2] -
    E[x]^2, 0)`` over ``tot = max(sum of weights, 1)`` rows, the variance
    clamp's gradient gate, and ``tot``. With ``update`` the running
    statistics move in place as ``momentum * old + (1 - momentum) *
    batch``."""
    stats = _stats_cuda if resolve_impl(impl, x) == "cuda" else _stats_plain
    return stats(x.detach(), mask, running_mean, running_var, float(eps), float(momentum),
                 bool(update))


# ------------------------------------------------------------ normalization


def _apply_plain(x, stats, scale, bias, relu, dtype):
    """nn/layers.py's normalization, given the statistics, and the ReLU its
    caller applies."""
    mean, rstd = _split(stats, x.shape[-1])[:2]
    y = (x - mean) * rstd
    y = (y * scale + bias).to(dtype)
    return torch.relu(y) if relu else y


def _apply_cuda(x, stats, scale, bias, relu, dtype):
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the BatchNorm kernel stores float32 or bfloat16, got {dtype}")
    x = _input(x)
    rows, c = x.shape
    _check_params(c, stats, scale, bias)
    out = torch.empty((rows, c), dtype=dtype, device=x.device)
    if rows and c:
        APPLY_KERNEL.launch(
            x.device, _cuda.ptr(x), _cuda.ptr(stats), _cuda.ptr(scale), _cuda.ptr(bias), rows, c,
            batch_norm_plan(rows, c), int(relu), int(dtype == torch.bfloat16), _cuda.ptr(out),
        )
    return out


def batch_norm_apply(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, *, relu: bool = False,
                     dtype: torch.dtype = torch.float32, impl: str = "auto") -> torch.Tensor:
    """``((x - mean) * rstd) * scale + bias`` for ``x (R, C)`` and ``stats``
    of :func:`batch_norm_stats`, then the ReLU where ``relu``, cast to
    ``dtype`` (the ReLU after the cast, as the module's caller applies
    it). No gradient: :func:`batch_norm_train` carries the layer's."""
    apply = _apply_cuda if resolve_impl(impl, x) == "cuda" else _apply_plain
    return apply(x, stats, scale, bias, bool(relu), dtype)


# ----------------------------------------------------------------- backward


def _grad_terms_plain(x, g, stats, scale, bias, relu):
    """What autograd computes through the module's chain before it reduces:
    ``gy`` (``threshold_backward`` of the ReLU over the stored output, in
    float32), ``gy * xhat``, ``(gy * scale) * (x - mean)`` and ``(gy *
    scale) * rstd``."""
    mean, rstd = _split(stats, x.shape[-1])[:2]
    xc = x - mean
    xhat = xc * rstd
    gy = g
    if relu:
        out = (xhat * scale + bias).to(g.dtype)
        gy = torch.where(out <= 0, torch.zeros_like(g), g)
    gy = gy.to(x.dtype)
    gs = gy * scale
    return gy, gy * xhat, gs * xc, gs * rstd


def _grad_terms_cuda(x, g, stats, scale, bias, relu):
    x = _input(x)
    rows, c = x.shape
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the output's gradient must be float32 or bfloat16, got {g.dtype}")
    gc = g.contiguous()
    _cuda.check_cuda_input("g", gc, g.dtype, (rows, c))
    _check_params(c, stats, scale, bias)
    bf16 = g.dtype == torch.bfloat16
    # each term a tensor of its own, as autograd's are (a reduction's order
    # can depend on its input's alignment); g itself where it is float32 and
    # no ReLU masks it (autograd sums it as it is)
    gy = torch.empty_like(x) if relu or bf16 else None
    ts, tr, td = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    if rows and c:
        TERMS_KERNEL.launch(
            x.device, _cuda.ptr(x), _cuda.ptr(gc), int(bf16), _cuda.ptr(stats), _cuda.ptr(scale),
            _cuda.ptr(bias), int(relu), rows, c, batch_norm_plan(rows, c), _cuda.ptr(gy),
            _cuda.ptr(ts), _cuda.ptr(tr), _cuda.ptr(td),
        )
    return (g if gy is None else gy), ts, tr, td


def batch_norm_grad_terms(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor, *, relu: bool = False,
                          impl: str = "auto"):
    """The first pass of the layer's backward, for the output's gradient
    ``g``: ``(gy, ts, tr, td)``, the ReLU's gradient in float32 and the
    terms whose column sums are the gradients of ``scale``, ``rstd`` and
    (negated) the mean. ``gy``'s sum is ``bias``' gradient; ``td`` is also
    ``dx``'s direct term (:func:`batch_norm_grad_input`)."""
    if resolve_impl(impl, x) == "cuda":
        return _grad_terms_cuda(x, g, stats, scale, bias, relu)
    return _grad_terms_plain(x, g, stats, scale, bias, relu)


def _grad_input_plain(x, td, mask, stats, sr, sd):
    """Autograd's steps from the sums back to ``dx``: rsqrt's backward
    ``-0.5 * grad * rstd^3``, the clamp's gate, the mean's gradient
    ``-sd`` plus ``mean * mean``'s two, the divisions by ``tot``, then
    ``dx``'s contributions in the order autograd adds them."""
    mean, rstd, gate, tot = _split(stats, x.shape[-1])
    gv = -0.5 * sr * rstd.pow(3)
    gv = torch.where(gate != 0, gv, torch.zeros_like(gv))
    mm = -gv * mean
    g1 = (-sd + mm + mm) / tot
    g2 = gv / tot
    if mask is None:
        sq = g2 * x
        return td + sq + sq + g1
    w = mask.reshape(x.shape[0]).to(x.dtype)[:, None]
    sq = g2 * w * x
    return td + sq + sq + g1 * w


def _grad_input_cuda(x, td, mask, stats, sr, sd):
    x = _input(x)
    rows, c = x.shape
    w, kind = _row_weights(mask, rows)
    _check_params(c, stats)
    for name, t in (("sr", sr), ("sd", sd)):
        _cuda.check_cuda_input(name, t, torch.float32, (c,))
    _cuda.check_cuda_input("td", td, torch.float32, (rows, c))
    dx = torch.empty_like(x)
    if rows and c:
        INPUT_KERNEL.launch(
            x.device, _cuda.ptr(x), _cuda.ptr(td), _cuda.ptr(w), kind, _cuda.ptr(stats),
            _cuda.ptr(sr), _cuda.ptr(sd), rows, c, batch_norm_plan(rows, c), _cuda.ptr(dx),
        )
    return dx


def batch_norm_grad_input(x: torch.Tensor, td: torch.Tensor, mask: torch.Tensor | None,
                          stats: torch.Tensor, sr: torch.Tensor, sd: torch.Tensor, *,
                          impl: str = "auto") -> torch.Tensor:
    """The second pass of the layer's backward: ``dx (R, C)`` from
    :func:`batch_norm_grad_terms`' ``td`` and the column sums ``sr`` of
    ``tr`` and ``sd`` of ``td``. The statistics' terms reach only the rows
    ``mask`` weighs."""
    if resolve_impl(impl, x) == "cuda":
        return _grad_input_cuda(x, td, mask, stats, sr, sd)
    return _grad_input_plain(x, td, mask, stats, sr, sd)


class _BatchNormTrain(torch.autograd.Function):
    """:func:`batch_norm_train` on an ``(R, C)`` input: the statistics and the
    normalization forward; backward the terms, PyTorch's column sums of
    them (``bias``' and ``scale``'s gradients among them), and ``dx``."""

    @staticmethod
    def forward(ctx, x, mask, scale, bias, running_mean, running_var, eps, momentum, update,
                relu, dtype, impl):
        stats = batch_norm_stats(x, mask, running_mean, running_var, eps=eps, momentum=momentum,
                                 update=update, impl=impl)
        ctx.save_for_backward(x, mask, stats, scale, bias)
        ctx.relu, ctx.impl = relu, impl
        return batch_norm_apply(x, stats, scale, bias, relu=relu, dtype=dtype, impl=impl)

    @staticmethod
    def backward(ctx, g):
        x, mask, stats, scale, bias = ctx.saved_tensors
        gy, ts, tr, td = batch_norm_grad_terms(x, g, stats, scale, bias, relu=ctx.relu,
                                               impl=ctx.impl)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = batch_norm_grad_input(x, td, mask, stats, tr.sum(dim=0), td.sum(dim=0),
                                       impl=ctx.impl)
        dscale = ts.sum(dim=0) if ctx.needs_input_grad[2] else None
        dbias = gy.sum(dim=0) if ctx.needs_input_grad[3] else None
        return dx, None, dscale, dbias, None, None, None, None, None, None, None, None


def batch_norm_train(x: torch.Tensor, mask: torch.Tensor | None, scale: torch.Tensor,
                     bias: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
                     *, eps: float, momentum: float, update: bool = True, relu: bool = False,
                     dtype: torch.dtype = torch.float32, impl: str = "auto") -> torch.Tensor:
    """A training-mode BatchNorm of ``x (..., C)`` (float32) over every
    non-channel axis, weighted by ``mask`` (broadcast against ``x``'s
    leading axes) when given, with the ReLU where ``relu``, cast to
    ``dtype``: :func:`batch_norm_stats` (blending the running statistics
    when ``update``), then :func:`batch_norm_apply`; differentiable in
    ``x``, ``scale`` and ``bias`` through :func:`batch_norm_grad_terms` and
    :func:`batch_norm_grad_input`. Bitwise ``MaskedBatchNorm``'s own code
    and its autograd gradients; on the card, two of the kernels' launches
    forward and two backward."""
    lead, c = x.shape[:-1], x.shape[-1]
    if mask is not None:
        mask = mask.expand(lead).reshape(-1)
    y = _BatchNormTrain.apply(x.reshape(-1, c), mask, scale, bias, running_mean, running_var,
                              float(eps), float(momentum), bool(update), bool(relu), dtype, impl)
    return y.reshape(*lead, c)
