"""Index-gather ops: ``gather_point`` and ``group_point``.

Counterparts of ``gspn_tpu/ops/grouping.py``. Indices are int32 at the
public surface (as in the JAX package); torch gathers need int64, so they
are widened here, at the point of use.
"""

from __future__ import annotations

import torch


def gather_point(inp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(B, N, C), (B, M) int -> (B, M, C)``."""
    i = idx.long()[..., None].expand(*idx.shape, inp.shape[-1])
    return torch.gather(inp, -2, i)


def group_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(B, N, C), (B, M, K) int -> (B, M, K, C)``."""
    b, _, c = points.shape
    m, k = idx.shape[-2:]
    flat = gather_point(points, idx.reshape(b, m * k))
    return flat.reshape(b, m, k, c)
