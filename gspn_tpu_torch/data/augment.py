"""Train-time scene augmentation on the device: the PyTorch counterpart of
``gspn_tpu/data/augment.py`` (rotation about z, x/y flips, a uniform scale
and clipped point jitter, one transform per scene)."""

from __future__ import annotations

import math

import torch

JITTER_SIGMA = 0.01
JITTER_CLIP = 0.05
SCALE_RANGE = (0.9, 1.1)


def augment_scene(xyz, valid=None, *, generator=None, theta=None, flips=None, scale=None,
                  noise=None, rot_z: bool = True, flip: bool = True,
                  jitter_sigma: float = JITTER_SIGMA, jitter_clip: float = JITTER_CLIP,
                  scale_range=SCALE_RANGE):
    """``xyz (B,N,3)`` -> augmented ``(B,N,3)``; padded points are set to 0.

    The transforms, each of the JAX package's options: ``rot_z``, a
    rotation about z by ``theta``; ``flip``, x and y negated where
    ``flips`` says so; ``scale_range`` (None: none), a uniform scale in it;
    ``jitter_sigma`` (0: none), N(0,1) noise times ``jitter_sigma``,
    clipped at ``jitter_clip``.

    The random draws may be given (a test feeds the JAX package's) or are
    drawn from ``generator`` on its device, in this order: ``theta (B,)``
    uniform in [0, 2 pi), ``flips (B,1,2)`` bool, ``scale (B,1,1)``
    uniform in ``scale_range`` (or ``SCALE_RANGE`` when that is None) and
    ``noise (B,N,3)`` standard normal. Every draw is taken whether or not its transform is on, so
    turning one off leaves the others' draws as they were, as the JAX
    package's four keys do."""
    b = xyz.shape[0]

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return lo + u * (hi - lo)

    if generator is None and any(v is None for v in (theta, flips, scale, noise)):
        raise ValueError("pass a torch.Generator or every draw")
    lo, hi = scale_range if scale_range is not None else SCALE_RANGE
    if theta is None:
        theta = uniform((b,), 0.0, 2 * math.pi)
    if flips is None:
        flips = uniform((b, 1, 2), 0.0, 1.0) < 0.5
    if scale is None:
        scale = uniform((b, 1, 1), lo, hi)
    if noise is None:
        noise = torch.randn(xyz.shape, generator=generator, device=generator.device)
    theta, flips, scale, noise = (v.to(xyz.device) for v in (theta, flips, scale, noise))

    out = xyz
    if rot_z:
        c = torch.cos(theta)[:, None]
        s = torch.sin(theta)[:, None]
        x, y, z = out[..., 0], out[..., 1], out[..., 2]
        out = torch.stack([c * x - s * y, s * x + c * y, z], dim=-1)
    if flip:
        sign = 1.0 - 2.0 * flips.to(out.dtype)  # +-1 for x and y
        out = torch.cat([out[..., 0:2] * sign, out[..., 2:3]], dim=-1)
    if scale_range is not None:
        out = out * scale
    if jitter_sigma:
        out = out + torch.clamp(noise * jitter_sigma, -jitter_clip, jitter_clip)
    if valid is not None:
        out = torch.where(valid[..., None], out, torch.zeros_like(out))
    return out
