"""GSPN proposal network (CVAE), inference forward: the PyTorch counterpart
of ``gspn_tpu/models/gspn.py``.

Per seed: multi-scale context crops (fused ball group), centre prediction,
contexts re-centred and encoded, a latent drawn from the learned prior,
a generated point set in the centre's frame, and an objectness logit. The
recognition branch and the losses are training-only and not ported.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from gspn_tpu_torch import ops
from gspn_tpu_torch.nn.layers import FCLayers, PointMLP


def not_ported(what: str, item: str) -> NotImplementedError:
    """``item`` is the title of the ROADMAP.md entry that ports ``what``
    (titles stay put when the queues are renumbered)."""
    return NotImplementedError(f'{what} is not ported to gspn_tpu_torch yet (ROADMAP.md, "{item}")')


KNOB_PATHS = "Knob paths"


@dataclasses.dataclass(frozen=True)
class GSPNConfig:
    """Architecture and cropping hyperparameters (same names and defaults as
    the JAX package's ``GSPNConfig``)."""

    context_radii: tuple[float, ...] = (0.25, 0.5, 1.0)
    context_nsample: tuple[int, ...] = (64, 128, 256)
    encoder_mlp: tuple[int, ...] = (64, 128, 256)
    center_mlp: tuple[int, ...] = (64, 128, 256)
    center_fc: tuple[int, ...] = (256, 128)
    latent_dim: int = 128
    cond_dim: int = 256
    generator_fc: tuple[int, ...] = (256, 512)
    num_gen_points: int = 256
    objectness_fc: tuple[int, ...] = (128,)
    feature_dim: int = 0
    use_bn: bool = True
    ops_impl: str = "auto"  # auto|cuda|plain (ops/common.py)
    fps_segments: int = 1  # read by the pipeline's seed sampling
    fps_segment_mode: str = "contiguous"
    group_select: str = "first"
    dtype: torch.dtype = torch.float32


def check_stage_config(cfg) -> None:
    """Raise ``ValueError`` for a ``group_select`` no version takes and
    ``NotImplementedError`` for the knobs of a stage config that this port
    does not run yet."""
    if cfg.feature_dim > 0:
        raise not_ported("feature_dim>0 (per-point input features)", KNOB_PATHS)
    if cfg.dtype != torch.float32:
        raise not_ported(f"dtype={cfg.dtype} (bf16 compute)", KNOB_PATHS)
    if cfg.group_select not in ("first", "strided"):
        raise ValueError(f"group_select must be first|strided, got {cfg.group_select!r}")


@dataclasses.dataclass
class GSPNOutputs:
    center: torch.Tensor  # (B, S, 3) predicted instance centres
    generated: torch.Tensor  # (B, S, G, 3) proposal shapes, world frame
    objectness: torch.Tensor  # (B, S) logits
    prior_mu: torch.Tensor  # (B, S, L)
    prior_logvar: torch.Tensor
    cond: torch.Tensor  # (B, S, cond_dim)


class PointNetEncoder(nn.Module):
    """Shared MLP + max pool over the K axis of ``(..., K, C)`` groups."""

    def __init__(self, in_dim, mlp, use_bn):
        super().__init__()
        self.mlp = PointMLP(in_dim, mlp, use_bn=use_bn)

    def forward(self, pts):
        return self.mlp(pts).amax(dim=-2)


class GaussianHead(nn.Module):
    """FC -> (mu, logvar), logvar clipped to [-10, 10]. The FC stack sits
    under ``FCLayers_0``, the name Flax gave it."""

    def __init__(self, in_dim, hidden, latent):
        super().__init__()
        self.FCLayers_0 = FCLayers(in_dim, hidden, 2 * latent)

    def forward(self, x):
        mu, logvar = self.FCLayers_0(x).chunk(2, dim=-1)
        return mu, torch.clamp(logvar, -10.0, 10.0)


class GSPN(nn.Module):
    """Scene points + seed indices -> proposals (inference)."""

    def __init__(self, config: GSPNConfig = GSPNConfig()):
        super().__init__()
        check_stage_config(config)
        cfg = self.config = config
        ns = len(cfg.context_radii)
        self.center_enc = PointNetEncoder(3, cfg.center_mlp, cfg.use_bn)
        self.center_fc = FCLayers(cfg.center_mlp[-1], cfg.center_fc, 3)
        for s in range(ns):
            self.add_module(f"ctx_enc_{s}", PointNetEncoder(3, cfg.encoder_mlp, cfg.use_bn))
        self.cond_fc = FCLayers(ns * cfg.encoder_mlp[-1], (), cfg.cond_dim)
        self.prior = GaussianHead(cfg.cond_dim, (cfg.cond_dim,), cfg.latent_dim)
        self.generator = FCLayers(
            cfg.latent_dim + cfg.cond_dim, cfg.generator_fc, cfg.num_gen_points * 3
        )
        self.objectness = FCLayers(cfg.cond_dim, cfg.objectness_fc, 1)

    def forward(self, xyz, seed_idx, valid=None, z_eps=None, generator=None) -> GSPNOutputs:
        """``xyz (B,N,3)``, ``seed_idx (B,S)`` int, ``valid (B,N)``;
        ``z_eps (B,S,latent)`` N(0,1) noise, or drawn from ``generator``."""
        cfg = self.config
        seed_xyz = ops.gather_point(xyz, seed_idx)  # (B, S, 3)
        per_scale = ops.query_ball_group_multi(
            cfg.context_radii, cfg.context_nsample, xyz, seed_xyz, valid,
            impl=cfg.ops_impl, select=cfg.group_select,
        )
        crops = [local for _, _, local in per_scale]  # (B, S, K_s, 3)

        offset = self.center_fc(self.center_enc(crops[-1]))
        center = seed_xyz + offset
        encs = [
            getattr(self, f"ctx_enc_{s}")(crops[s] - offset[:, :, None, :])
            for s in range(len(crops))
        ]
        cond = torch.relu(self.cond_fc(torch.cat(encs, dim=-1)))
        prior_mu, prior_logvar = self.prior(cond)

        if z_eps is None:
            if generator is None:
                raise ValueError("pass z_eps (noise) or a torch.Generator")
            z_eps = torch.randn(
                prior_mu.shape, generator=generator, dtype=torch.float32,
                device=generator.device,
            ).to(prior_mu.device)
        z = prior_mu + z_eps.to(torch.float32) * torch.exp(0.5 * prior_logvar)

        gen = self.generator(torch.cat([z, cond], dim=-1))
        gen = gen.reshape(*gen.shape[:-1], cfg.num_gen_points, 3)
        generated = gen + center[:, :, None, :]
        objectness = self.objectness(cond)[..., 0]
        return GSPNOutputs(center, generated, objectness, prior_mu, prior_logvar, cond)


def proposal_boxes(generated: torch.Tensor, margin: float = 0.1, percentile: float = 0.0):
    """Axis-aligned boxes from generated-shape extents plus ``margin``,
    ``(B,S,G,3) -> (B,S,6)``; ``percentile > 0`` trims outliers per side."""
    if percentile > 0.0:
        lo = torch.quantile(generated, percentile, dim=-2) - margin
        hi = torch.quantile(generated, 1.0 - percentile, dim=-2) + margin
    else:
        lo = generated.amin(dim=-2) - margin
        hi = generated.amax(dim=-2) + margin
    return torch.cat([lo, hi], dim=-1)
