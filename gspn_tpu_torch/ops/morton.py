"""Morton (z-order) codes and the stable spatial sort order.

Counterpart of ``gspn_tpu/ops/morton.py``: 30-bit codes from coordinates
normalized to each scene's valid-point bounding box; invalid points get the
sentinel ``2**30`` and sort last.
"""

from __future__ import annotations

import torch


def _spread_bits3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``v`` so bit i lands at position 3*i."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(xyz: torch.Tensor, valid: torch.Tensor | None = None, bits: int = 10):
    """``(B, N, 3) -> (B, N)`` int32 Morton codes."""
    if not 1 <= bits <= 10:
        raise ValueError(f"bits must be in 1..10, got {bits}")
    if valid is not None:
        v3 = valid[..., None]
        big = torch.full_like(xyz, 1e30)
        lo = torch.where(v3, xyz, big).amin(dim=1, keepdim=True)
        hi = torch.where(v3, xyz, -big).amax(dim=1, keepdim=True)
    else:
        lo = xyz.amin(dim=1, keepdim=True)
        hi = xyz.amax(dim=1, keepdim=True)
    nmax = (1 << bits) - 1
    # a true division: ``nmax / tensor`` would run as ``reciprocal * nmax``
    # and round differently from the JAX package
    scale = torch.full_like(lo, float(nmax)) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((xyz - lo) * scale, 0, nmax).to(torch.int32)
    code = (
        _spread_bits3(q[..., 0])
        | (_spread_bits3(q[..., 1]) << 1)
        | (_spread_bits3(q[..., 2]) << 2)
    )
    if valid is not None:
        code = torch.where(valid, code, torch.full_like(code, 1 << 30))
    return code


def spatial_order(xyz, valid=None, bits: int = 10) -> torch.Tensor:
    """Stable Morton sort permutation, ``(B, N)`` int32 (ties keep input
    order; invalid points last)."""
    codes = morton_codes(xyz, valid, bits)
    return torch.sort(codes, dim=-1, stable=True).indices.to(torch.int32)
