"""Layer helpers: the PyTorch counterpart of ``gspn_tpu/nn/layers.py``.

Submodules are named after the Flax scopes (``dense_0``, ``bn_0``,
``fc_0``, ``fc_out``) so that carrying JAX weights across is a mechanical
rename (``gspn_tpu_torch/convert.py``). Shared per-point MLPs are
``nn.Linear`` on the channel axis, as the JAX package uses ``nn.Dense``:
a float32 matrix product that cuDNN's TF32 default for ``Conv1d`` would
otherwise round.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
from torch import nn

# The model-level BatchNorm momentum of the JAX package: running statistics
# update as ``m * old + (1 - m) * batch`` (the opposite of torch's
# ``momentum``, which weighs the batch).
BN_MOMENTUM = 0.9


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
    batch``, outside autograd. In eval mode the running statistics
    normalize."""

    def __init__(self, c: int, epsilon: float = 1e-3, momentum: float = BN_MOMENTUM):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if not self.training:
            y = (x - self.mean) * torch.rsqrt(self.var + self.epsilon)
            return y * self.scale + self.bias
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
        tot = torch.clamp(tot, min=1.0)
        mean = s1 / tot
        var = torch.clamp(s2 / tot - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.scale + self.bias


class PointMLP(nn.Module):
    """Shared per-point MLP: ``Linear (+BN) + ReLU`` per width, on the last
    axis of any ``(..., C)`` input (every caller activates the last layer
    too). The leading axes are flattened into one, as the JAX package
    does; ``mask`` (the leading axes' shape, or broadcastable to it)
    weights the BatchNorm training statistics."""

    def __init__(self, in_dim: int, features: Sequence[int], use_bn: bool = True):
        super().__init__()
        self.n = len(features)
        self.use_bn = use_bn
        dims = [in_dim, *features]
        for i, ch in enumerate(features):
            self.add_module(f"dense_{i}", nn.Linear(dims[i], ch))
            if use_bn:
                self.add_module(f"bn_{i}", MaskedBatchNorm(ch))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        if mask is not None:
            mask = mask.expand(lead).reshape(-1)
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x, mask)
            x = torch.relu(x)
        return x.reshape(*lead, x.shape[-1])


class FCLayers(nn.Module):
    """Fully-connected head: ``Linear + ReLU`` per hidden width, then a linear
    output ``fc_out`` (no BatchNorm and no dropout, as every GSPN and
    R-PointNet head the port runs uses it)."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out: int):
        super().__init__()
        self.n = len(hidden)
        dims = [in_dim, *hidden]
        for i, ch in enumerate(hidden):
            self.add_module(f"fc_{i}", nn.Linear(dims[i], ch))
        self.fc_out = nn.Linear(dims[-1], out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = torch.relu(getattr(self, f"fc_{i}")(x))
        return self.fc_out(x)


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
