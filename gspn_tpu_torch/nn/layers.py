"""Layer helpers: the PyTorch counterpart of ``gspn_tpu/nn/layers.py``.

Submodules are named after the Flax scopes (``dense_0``, ``bn_0``,
``fc_0``, ``fc_out``) so that carrying JAX weights across is a mechanical
rename (``gspn_tpu_torch/convert.py``). Shared per-point MLPs are
:class:`Dense` (an ``nn.Linear``) on the channel axis, as the JAX package
uses ``nn.Dense``: a float32 matrix product that cuDNN's TF32 default for
``Conv1d`` would otherwise round.

``dtype`` is the compute dtype of the MLPs and heads, as in the JAX
package (``dtype`` / ``param_dtype``): the parameters and BatchNorm's
running statistics stay float32, a bfloat16 layer casts its input and
parameters to bfloat16, and BatchNorm normalizes in float32 and casts its
output back.
"""

from __future__ import annotations

import contextlib
import math
import threading
from collections.abc import Sequence

import torch
import torch.distributed as dist
from torch import nn

from gspn_tpu_torch.ops.batchnorm import batch_norm_train
from gspn_tpu_torch.ops.common import resolve_impl

# The model-level BatchNorm momentum of the JAX package: running statistics
# update as ``m * old + (1 - m) * batch`` (the opposite of torch's
# ``momentum``, which weighs the batch).
BN_MOMENTUM = 0.9

# set within running_statistics_held(), per thread
_HELD = threading.local()


class _AllReduceSum(torch.autograd.Function):
    """The sum over a process group's ranks, whose gradient is the sum of
    every rank's output gradient (JAX's ``psum`` and its transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of the process ``group`` (a new tensor),
    with the gradient flowing back to every rank's input: on each rank it
    is the sum of the ranks' output gradients. When every rank computes
    the same global loss, the ranks' gradients are then ``size`` times
    their shares of the global gradient, and their mean is the global
    gradient (``parallel/dp.py``)."""
    return _AllReduceSum.apply(x, group)


def _gather_parts(x: torch.Tensor, group) -> list[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


class _AllGatherTiled(torch.autograd.Function):
    """Every rank's tensor concatenated along ``dim`` in rank order, whose
    gradient is the sum of every rank's output gradient, sliced to this
    rank's part (JAX's ``all_gather(tiled=True)`` and its transpose, a
    ``psum_scatter``; gloo has no reduce-scatter, so an all-reduce and a
    slice)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(_gather_parts(x.contiguous(), group), dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        part = grad.chunk(dist.get_world_size(ctx.group), ctx.dim)[dist.get_rank(ctx.group)]
        return part.contiguous(), None, None


def all_gather_tiled(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` of the process ``group`` concatenated along ``dim``
    in rank order (``x`` itself for None: this rank alone). The gradient
    reaching this rank's ``x`` is its slice of the sum of the ranks' output
    gradients, so that, as with :func:`all_reduce_sum`, the mean of the
    ranks' gradients is the global one when every rank computes the same
    global loss. Bool tensors travel as ``uint8`` and take no gradient."""
    if group is None:
        return x
    if x.dtype == torch.bool:
        return torch.cat(_gather_parts(x.to(torch.uint8), group), dim).bool()
    return _AllGatherTiled.apply(x, dim, group)


class MaskedBatchNorm(nn.Module):
    """Batch norm with the JAX package's conventions: channel axis last,
    ``epsilon=1e-3`` and ``(x - mean) * rsqrt(var + eps) * scale + bias``
    written out by hand (``nn.BatchNorm1d`` puts the channel axis second and
    uses 1e-5). ``scale``/``bias`` are parameters, ``mean``/``var`` the
    running statistics (buffers).

    In training mode (``module.training``) the statistics are taken over
    every non-channel axis, weighted by ``mask`` (broadcast against ``x``
    without the channel axis) when one is given: the biased variance
    ``max(E[x^2] - E[x]^2, 0)`` over ``max(sum of weights, 1)`` entries. The
    running statistics then move as ``momentum * old + (1 - momentum) *
    batch``, outside autograd, unless :func:`running_statistics_held` is
    on (a rematerialized forward recomputed in backward). In eval mode the
    running statistics normalize. The input is normalized in float32 and the output cast to
    ``dtype``.

    ``group``: a process group whose ranks hold the other shards of the
    batch (``cross_rank_statistics``; None alone). The training statistics
    are then taken over all of them, as the JAX package's ``axis_name``:
    the sums and the count are summed over the ranks (``all_reduce_sum``,
    the gradient reaching every rank's input) before the mean and variance
    are formed.

    ``relu``: the ReLU after the normalization (and the cast), as
    :class:`PointMLP` applies it. ``ops_impl`` (``ops/common.py``): where it
    resolves to the CUDA kernels for the input, training mode without a
    ``group`` runs ``ops.batchnorm.batch_norm_train``: the statistics, the
    normalization, the ReLU and their backward on four hand-written kernels
    around PyTorch's column sums, bitwise this module's code and its
    autograd gradients, which run everywhere else."""

    def __init__(self, c: int, epsilon: float = 1e-3, momentum: float = BN_MOMENTUM,
                 dtype: torch.dtype = torch.float32, ops_impl: str = "auto"):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.dtype = dtype
        self.ops_impl = ops_impl
        self.group = None
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                relu: bool = False) -> torch.Tensor:
        x = x.float()
        if self.training and self.group is None and resolve_impl(self.ops_impl, x) == "cuda":
            return batch_norm_train(
                x, mask, self.scale, self.bias, self.mean, self.var, eps=self.epsilon,
                momentum=self.momentum, update=not getattr(_HELD, "on", False), relu=relu,
                dtype=self.dtype)
        y = self._normalize(x, mask)
        return torch.relu(y) if relu else y

    def _normalize(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        if not self.training:
            y = (x - self.mean) * torch.rsqrt(self.var + self.epsilon)
            return (y * self.scale + self.bias).to(self.dtype)
        red = tuple(range(x.ndim - 1))
        if mask is None:
            # a device tensor: a CPU scalar divisor would run as a multiply
            # by its reciprocal on the card
            tot = torch.full((), float(x.numel() // x.shape[-1]), dtype=x.dtype, device=x.device)
            s1 = x.sum(dim=red)
            s2 = (x * x).sum(dim=red)
        else:
            w = mask.to(x.dtype)[..., None]
            tot = w.sum()
            s1 = (x * w).sum(dim=red)
            s2 = (x * x * w).sum(dim=red)
        if self.group is not None:
            c = x.shape[-1]
            s1, s2, tot = all_reduce_sum(torch.cat([s1, s2, tot.reshape(1)]),
                                         self.group).split([c, c, 1])
            tot = tot.reshape(())
        tot = torch.clamp(tot, min=1.0)
        mean = s1 / tot
        var = torch.clamp(s2 / tot - mean * mean, min=0.0)
        if not getattr(_HELD, "on", False):
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale + self.bias).to(self.dtype)


@contextlib.contextmanager
def running_statistics_held():
    """Within the block (on this thread), every :class:`MaskedBatchNorm` in
    training mode normalizes by its batch statistics as always but leaves
    its running statistics alone: the forward that a rematerialized module
    runs again in backward must not blend them a second time."""
    prev = getattr(_HELD, "on", False)
    _HELD.on = True
    try:
        yield
    finally:
        _HELD.on = prev


@contextlib.contextmanager
def cross_rank_statistics(model: nn.Module, group):
    """Within the block, every :class:`MaskedBatchNorm` of ``model`` takes
    its training statistics over the ranks of the process ``group`` (a
    no-op for None: this process's batch alone)."""
    if group is None:
        yield model
        return
    bns = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    for m in bns:
        m.group = group
    try:
        yield model
    finally:
        for m in bns:
            m.group = None


class Dense(nn.Linear):
    """``nn.Linear`` with float32 parameters computing in ``dtype``. In
    bfloat16, Flax's ``nn.Dense``: the input, kernel and bias cast to
    bfloat16, the product rounded to bfloat16, then the bias added in
    bfloat16 (two roundings, where ``F.linear`` in bfloat16 would round
    once)."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(in_dim, out_dim)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, sum_in_f32: bool = False) -> torch.Tensor:
        """``sum_in_f32``: the caller reads the output in float32 (a
        BatchNorm does), and the bias is added to the rounded product in
        float32, without the second rounding, as XLA computes that pair."""
        if self.dtype == torch.float32:
            return super().forward(x.float())
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())
        if sum_in_f32:
            return y.float() + self.bias.to(self.dtype).float()
        return y + self.bias.to(self.dtype)


class PointMLP(nn.Module):
    """Shared per-point MLP: ``Linear (+BN) + ReLU`` per width, on the last
    axis of any ``(..., C)`` input; ``last_activation=False`` leaves the
    last layer's ReLU out (every model activates it). The leading axes are
    flattened into one, as the JAX package does; ``mask`` (the leading
    axes' shape, or broadcastable to it) weights the BatchNorm training
    statistics, whose running averages move at ``bn_momentum``. Each
    BatchNorm applies the ReLU after it, and takes its kernels on
    ``ops_impl``'s route (:class:`MaskedBatchNorm`)."""

    def __init__(self, in_dim: int, features: Sequence[int], use_bn: bool = True,
                 dtype: torch.dtype = torch.float32, bn_momentum: float = BN_MOMENTUM,
                 last_activation: bool = True, ops_impl: str = "auto"):
        super().__init__()
        self.n = len(features)
        self.use_bn = use_bn
        self.last_activation = last_activation
        dims = [in_dim, *features]
        for i, ch in enumerate(features):
            self.add_module(f"dense_{i}", Dense(dims[i], ch, dtype))
            if use_bn:
                self.add_module(f"bn_{i}", MaskedBatchNorm(ch, momentum=bn_momentum, dtype=dtype,
                                                           ops_impl=ops_impl))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        if mask is not None:
            mask = mask.expand(lead).reshape(-1)
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x, sum_in_f32=self.use_bn)
            relu = i < self.n - 1 or self.last_activation
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x, mask, relu=relu)
            elif relu:
                x = torch.relu(x)
        return x.reshape(*lead, x.shape[-1])


class FCLayers(nn.Module):
    """Fully-connected head: ``Linear (+BN) + ReLU (+ dropout)`` per hidden
    width, then a linear output ``fc_out``. ``use_bn`` puts a
    :class:`MaskedBatchNorm` (``bn_<i>``, which applies the ReLU) after each
    hidden ``Linear``; every GSPN and R-PointNet head of both packages
    leaves it out.
    ``dropout`` is the rate of :func:`dropout` after each hidden ReLU, in
    training mode only."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, use_bn: bool = False):
        super().__init__()
        self.n = len(hidden)
        self.dropout = dropout
        self.use_bn = use_bn
        dims = [in_dim, *hidden]
        for i, ch in enumerate(hidden):
            self.add_module(f"fc_{i}", Dense(dims[i], ch, dtype))
            if use_bn:
                self.add_module(f"bn_{i}", MaskedBatchNorm(ch, dtype=dtype))
        self.fc_out = Dense(dims[-1], out, dtype)

    def forward(self, x: torch.Tensor, keep=None, generator=None) -> torch.Tensor:
        """``keep``: one bool mask a hidden layer (its output's shape), the
        elements dropout keeps; without it, training-mode dropout draws them
        from ``generator``, layer by layer."""
        for i in range(self.n):
            x = getattr(self, f"fc_{i}")(x, sum_in_f32=self.use_bn)
            x = getattr(self, f"bn_{i}")(x, relu=True) if self.use_bn else torch.relu(x)
            if self.dropout > 0.0 and self.training:
                x = dropout(x, self.dropout, None if keep is None else keep[i], generator)
        return self.fc_out(x)


def dropout(x: torch.Tensor, rate: float, keep: torch.Tensor | None = None,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Flax's ``nn.Dropout`` in training: ``where(keep, x / (1 - rate), 0)``
    with a true division by a device scalar (``F.dropout`` multiplies by
    ``1 / (1 - rate)``, which rounds differently), zeros at ``rate`` 1.
    ``keep`` (bool, ``x``'s shape) is drawn from ``generator`` as
    ``jax.random.bernoulli`` draws it, ``uniform < 1 - rate``, when not
    given."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    if keep is None:
        if generator is None:
            raise ValueError("training-mode dropout needs its keep mask or a torch.Generator")
        u = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(x.device)
        keep = u < keep_prob
    scaled = x / torch.full((), keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, scaled, torch.zeros_like(x))


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Max-pool over ``dim`` ignoring masked-out entries; ``mask``
    broadcasts against ``x`` without the channel axis. Rows with no valid
    entry return 0."""
    m = mask[..., None]
    xm = torch.where(m, x, torch.full_like(x, -1e10))
    out = xm.amax(dim=dim)
    any_valid = m.any(dim=dim)
    return torch.where(any_valid, out, torch.zeros_like(out))


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Mean over ``dim`` of the entries ``mask`` keeps (``mask`` broadcasts
    against ``x`` without the channel axis); rows with none return 0."""
    w = mask.to(x.dtype)[..., None]
    return (x * w).sum(dim=dim) / torch.clamp(w.sum(dim=dim), min=1.0)


def glorot_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialize ``module`` as the JAX package does: glorot-uniform
    ``Linear`` weights drawn from ``generator`` in module order, zero biases
    (BatchNorm keeps scale 1, bias 0, mean 0, var 1). The draws are
    reproducible but are not the JAX package's numbers."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, nn.Linear):
                fan_out, fan_in = mod.weight.shape
                limit = math.sqrt(6.0 / (fan_in + fan_out))
                mod.weight.uniform_(-limit, limit, generator=generator)
                nn.init.zeros_(mod.bias)
