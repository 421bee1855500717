"""Train-time scene augmentation on the device: the PyTorch counterpart of
``gspn_tpu/data/augment.py`` (rotation about z, x/y flips, a uniform scale
and clipped point jitter, one transform per scene)."""

from __future__ import annotations

import math

import torch

JITTER_SIGMA = 0.01
JITTER_CLIP = 0.05
SCALE_RANGE = (0.9, 1.1)


def augment_scene(xyz, valid=None, *, generator=None, theta=None, flip=None, scale=None,
                  noise=None):
    """``xyz (B,N,3)`` -> augmented ``(B,N,3)``; padded points are set to 0.

    The random draws may be given (a test feeds the JAX package's) or are
    drawn from ``generator`` on its device: ``theta (B,)`` uniform in
    [0, 2 pi), ``flip (B,1,2)`` bool (negate x / y), ``scale (B,1,1)``
    uniform in ``SCALE_RANGE``, ``noise (B,N,3)`` standard normal (scaled by
    ``JITTER_SIGMA``, clipped at ``JITTER_CLIP``)."""
    b = xyz.shape[0]

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return lo + u * (hi - lo)

    if generator is None and any(v is None for v in (theta, flip, scale, noise)):
        raise ValueError("pass a torch.Generator or every draw")
    if theta is None:
        theta = uniform((b,), 0.0, 2 * math.pi)
    if flip is None:
        flip = uniform((b, 1, 2), 0.0, 1.0) < 0.5
    if scale is None:
        scale = uniform((b, 1, 1), *SCALE_RANGE)
    if noise is None:
        noise = torch.randn(xyz.shape, generator=generator, device=generator.device)
    theta, flip, scale, noise = (v.to(xyz.device) for v in (theta, flip, scale, noise))

    c = torch.cos(theta)[:, None]
    s = torch.sin(theta)[:, None]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    out = torch.stack([c * x - s * y, s * x + c * y, z], dim=-1)
    sign = 1.0 - 2.0 * flip.to(out.dtype)  # +-1 for x and y
    out = torch.cat([out[..., 0:2] * sign, out[..., 2:3]], dim=-1)
    out = out * scale
    out = out + torch.clamp(noise * JITTER_SIGMA, -JITTER_CLIP, JITTER_CLIP)
    if valid is not None:
        out = torch.where(valid[..., None], out, torch.zeros_like(out))
    return out
