"""Ball query (fixed-radius neighborhood), plain first-K semantics.

Counterpart of ``gspn_tpu/ops/ball_query.py`` (``_ball_query_xla`` and
``_finalize``): for each query, the first ``nsample`` dataset points in
input order with squared distance strictly below ``radius**2``; slots past
the count repeat the first hit; an empty query gets index 0 and count 0.
The CUDA route is the fused ball-group kernel (``ops/ball_group.py``).
"""

from __future__ import annotations

import torch

from gspn_tpu_torch.ops.common import f32_scalar, pairwise_sqdist


def finalize(idx_asc: torch.Tensor, cnt: torch.Tensor, nsample: int):
    """Replicate-first padding and zero rows for empty queries."""
    first = idx_asc[..., 0:1]
    k = torch.arange(nsample, device=idx_asc.device)
    idx = torch.where(k < cnt[..., None], idx_asc, first)
    idx = torch.where(cnt[..., None] > 0, idx, torch.zeros_like(idx))
    return idx.to(torch.int32), cnt.to(torch.int32)


def first_k_hits(hit: torch.Tensor, k: int) -> torch.Tensor:
    """Ascending positions of the first ``k`` True entries of each row of
    ``hit (..., N)``; unfilled slots read 0 (masked later by the count).
    Positions are unique, so the selection has no ties to break."""
    n = hit.shape[-1]
    iota = torch.arange(n, dtype=torch.int32, device=hit.device)
    pos = torch.where(hit, iota, torch.full_like(iota, n))
    first = torch.topk(pos, k, dim=-1, largest=False, sorted=True).values
    return torch.where(first >= n, torch.zeros_like(first), first)


def ball_query_plain(radius: float, nsample: int, xyz1, xyz2, valid1=None):
    """``xyz1 (B,N,3)`` dataset, ``xyz2 (B,M,3)`` queries -> ``idx
    (B,M,nsample)`` int32, ``cnt (B,M)`` int32."""
    d2 = pairwise_sqdist(xyz2, xyz1)  # (B, M, N)
    hit = d2 < f32_scalar(float(radius) * float(radius), d2.device)
    if valid1 is not None:
        hit = hit & valid1[:, None, :]
    cnt = torch.clamp(hit.sum(dim=-1), max=nsample)
    return finalize(first_k_hits(hit, nsample), cnt, nsample)
