"""Probability (inverse-CDF) sampling: the PyTorch counterpart of
``gspn_tpu/ops/sampling.py``.

``prob_sample(inps, inp_r)`` samples each row of non-negative weights
``inps (B, N)`` (not normalized: the target is scaled by the row's total)
at uniforms ``inp_r (B, M)`` in ``[0, 1)``: the first index whose
inclusive cumulative sum reaches ``r * total``, as the reference's
``cumsum`` and binary search do. Plain PyTorch on every device, as the
JAX package runs it in XLA.
"""

from __future__ import annotations

import torch


def prob_sample(inps: torch.Tensor, inp_r: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF categorical sampling: ``inps (B,N)`` weights, ``inp_r
    (B,M)`` uniforms in ``[0,1)`` -> ``(B,M)`` int32 indices, clamped to
    ``N - 1``."""
    cdf = torch.cumsum(inps.to(torch.float32), dim=-1)  # (B, N)
    target = inp_r.to(torch.float32) * cdf[..., -1:]
    idx = torch.searchsorted(cdf, target.contiguous(), side="left")
    return torch.clamp(idx, max=inps.shape[-1] - 1).to(torch.int32)


def random_prob_sample(inps: torch.Tensor, m: int, generator: torch.Generator) -> torch.Tensor:
    """``m`` samples a row of ``inps (B, N)`` at uniforms drawn from
    ``generator`` (one ``(B, m)`` draw) -> ``(B, m)`` int32."""
    r = torch.rand((inps.shape[0], m), generator=generator, dtype=torch.float32,
                   device=generator.device).to(inps.device)
    return prob_sample(inps, r)
