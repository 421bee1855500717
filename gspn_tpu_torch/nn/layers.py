"""Layer helpers: the PyTorch counterpart of ``gspn_tpu/nn/layers.py``
(inference only).

Submodules are named after the Flax scopes (``dense_0``, ``bn_0``,
``fc_0``, ``fc_out``) so that carrying JAX weights across is a mechanical
rename (``gspn_tpu_torch/convert.py``). Shared per-point MLPs are
``nn.Linear`` on the channel axis, as the JAX package uses ``nn.Dense``:
a float32 matrix product that cuDNN's TF32 default for ``Conv1d`` would
otherwise round.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """Batch norm in eval mode with the JAX package's conventions: channel
    axis last, ``epsilon=1e-3`` and ``(x - mean) * rsqrt(var + eps) * scale
    + bias`` written out by hand (``nn.BatchNorm1d`` puts the channel axis
    second and uses 1e-5). ``scale``/``bias`` are parameters, ``mean``/``var``
    the running statistics (buffers). Training statistics are not ported."""

    def __init__(self, c: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (x - self.mean) * torch.rsqrt(self.var + self.epsilon)
        return y * self.scale + self.bias


class PointMLP(nn.Module):
    """Shared per-point MLP: ``Linear (+BN) + ReLU`` per width, on the last
    axis of any ``(..., C)`` input (every caller activates the last layer
    too)."""

    def __init__(self, in_dim: int, features: Sequence[int], use_bn: bool = True):
        super().__init__()
        self.n = len(features)
        self.use_bn = use_bn
        dims = [in_dim, *features]
        for i, ch in enumerate(features):
            self.add_module(f"dense_{i}", nn.Linear(dims[i], ch))
            if use_bn:
                self.add_module(f"bn_{i}", MaskedBatchNorm(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x)
            x = torch.relu(x)
        return x


class FCLayers(nn.Module):
    """Fully-connected head: ``Linear + ReLU`` per hidden width, then a linear
    output ``fc_out`` (no BatchNorm, as every JAX caller uses it; dropout is
    a no-op in eval and not ported)."""

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
