"""GSPN proposal network (CVAE): the PyTorch counterpart of
``gspn_tpu/models/gspn.py``.

Per seed: multi-scale context crops (fused ball group), centre prediction,
contexts re-centred and encoded, a latent, a generated point set in the
centre's frame, and an objectness logit. At inference the latent is drawn
from the learned prior; in training (``GSPN(cfg, recognition=True)`` given
the seeds' GT instances) the recognition network encodes the GT and the
latent is drawn from its posterior. The training loss is :func:`gspn_loss`.

``feature_dim > 0``: each crop carries the grouped per-point features
after its local coordinates. ``dtype``: the MLPs' and heads' compute dtype
(``nn.layers``); the crops, the centre, the generated points and the
outputs other than ``cond`` are float32, where the JAX package casts them.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

import torch.nn.functional as F

from gspn_tpu_torch import ops
from gspn_tpu_torch.nn.layers import FCLayers, PointMLP, all_reduce_sum, masked_max


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


def shapenet_config(num_points: int = 1024, num_gen_points: int = 1024) -> GSPNConfig:
    """The single-object CVAE pretraining config (BASELINE.json config 1):
    the whole unit-normalized object is one context of ``num_points``
    points at one radius, 2.0."""
    return GSPNConfig(context_radii=(2.0,), context_nsample=(num_points,),
                      num_gen_points=num_gen_points)


def check_stage_config(cfg) -> None:
    """Raise ``ValueError`` for a value of a stage config no version
    takes."""
    if cfg.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {cfg.dtype}")
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
    q_mu: torch.Tensor | None = None  # (B, S, L), when GT was given (training)
    q_logvar: torch.Tensor | None = None


class PointNetEncoder(nn.Module):
    """Shared MLP + max pool over the K axis of ``(..., K, C)`` groups;
    with ``mask (..., K)`` the pool and the BatchNorm statistics skip the
    masked-out points."""

    def __init__(self, in_dim, mlp, use_bn, dtype=torch.float32, ops_impl="auto"):
        super().__init__()
        self.mlp = PointMLP(in_dim, mlp, use_bn=use_bn, dtype=dtype, ops_impl=ops_impl)

    def forward(self, pts, mask=None):
        h = self.mlp(pts, mask)
        if mask is not None:
            return masked_max(h, mask, dim=-2)
        return h.amax(dim=-2)


class GaussianHead(nn.Module):
    """FC -> (mu, logvar), logvar clipped to [-10, 10]. The FC stack sits
    under ``FCLayers_0``, the name Flax gave it."""

    def __init__(self, in_dim, hidden, latent, dtype=torch.float32):
        super().__init__()
        self.FCLayers_0 = FCLayers(in_dim, hidden, 2 * latent, dtype=dtype)

    def forward(self, x):
        mu, logvar = self.FCLayers_0(x).chunk(2, dim=-1)
        return mu, torch.clamp(logvar, -10.0, 10.0)


class GSPN(nn.Module):
    """Scene points + seed indices (+ the seeds' GT instances in training)
    -> proposals.

    ``recognition=True`` builds the recognition network (``recog_enc``,
    ``recognition``), registered after the inference modules, so the
    inference model's state-dict keys and seeded draws stay as they are."""

    def __init__(self, config: GSPNConfig = GSPNConfig(), recognition: bool = False):
        super().__init__()
        check_stage_config(config)
        cfg = self.config = config
        ns, dt = len(cfg.context_radii), cfg.dtype
        crop_dim = 3 + cfg.feature_dim
        self.center_enc = PointNetEncoder(crop_dim, cfg.center_mlp, cfg.use_bn, dt, cfg.ops_impl)
        self.center_fc = FCLayers(cfg.center_mlp[-1], cfg.center_fc, 3, dtype=dt)
        for s in range(ns):
            self.add_module(f"ctx_enc_{s}",
                            PointNetEncoder(crop_dim, cfg.encoder_mlp, cfg.use_bn, dt,
                                            cfg.ops_impl))
        self.cond_fc = FCLayers(ns * cfg.encoder_mlp[-1], (), cfg.cond_dim, dtype=dt)
        self.prior = GaussianHead(cfg.cond_dim, (cfg.cond_dim,), cfg.latent_dim, dt)
        self.generator = FCLayers(
            cfg.latent_dim + cfg.cond_dim, cfg.generator_fc, cfg.num_gen_points * 3, dtype=dt
        )
        self.objectness = FCLayers(cfg.cond_dim, cfg.objectness_fc, 1, dtype=dt)
        self.has_recognition = recognition
        if recognition:
            self.recog_enc = PointNetEncoder(3, cfg.encoder_mlp, cfg.use_bn, dt, cfg.ops_impl)
            self.recognition = GaussianHead(
                cfg.encoder_mlp[-1] + cfg.cond_dim, (cfg.cond_dim,), cfg.latent_dim, dt
            )

    def forward(self, xyz, seed_idx, valid=None, z_eps=None, generator=None,
                gt_points=None, gt_valid=None, features=None) -> GSPNOutputs:
        """``xyz (B,N,3)``, ``seed_idx (B,S)`` int, ``valid (B,N)``;
        ``z_eps (B,S,latent)`` N(0,1) noise, or drawn from ``generator``.
        ``gt_points (B,S,G,3)`` and ``gt_valid (B,S,G)``, the seeds' GT
        instances (training), draw the latent from the recognition
        network's posterior instead of the prior. ``features (B,N,F)``:
        the per-point input features, read when ``feature_dim > 0``."""
        cfg = self.config
        seed_xyz = ops.gather_point(xyz, seed_idx, impl=cfg.ops_impl)  # (B, S, 3)
        per_scale = ops.query_ball_group_multi(
            cfg.context_radii, cfg.context_nsample, xyz, seed_xyz, valid,
            impl=cfg.ops_impl, select=cfg.group_select,
        )
        if cfg.feature_dim > 0:
            if features is None:
                raise ValueError(f"the config has feature_dim={cfg.feature_dim}: pass features")
            crops = [torch.cat([local, ops.group_point(features, idx, impl=cfg.ops_impl)], -1)
                     for idx, _, local in per_scale]  # (B, S, K_s, 3 + F)
        else:
            crops = [local for _, _, local in per_scale]  # (B, S, K_s, 3)

        offset = self.center_fc(self.center_enc(crops[-1]))
        center = seed_xyz + offset.float()
        off = offset.float()[:, :, None, :]
        encs = [
            getattr(self, f"ctx_enc_{s}")(
                crops[s] - off if cfg.feature_dim == 0
                else torch.cat([crops[s][..., :3] - off, crops[s][..., 3:]], -1))
            for s in range(len(crops))
        ]
        cond = torch.relu(self.cond_fc(torch.cat(encs, dim=-1)))
        prior_mu, prior_logvar = self.prior(cond)

        q_mu = q_logvar = None
        if gt_points is not None:
            if not self.has_recognition:
                raise ValueError("gt_points needs the recognition network: "
                                 "build GSPN(config, recognition=True)")
            gt_feat = self.recog_enc(gt_points - center[:, :, None, :], gt_valid)
            q_mu, q_logvar = self.recognition(torch.cat([gt_feat, cond], dim=-1))

        if z_eps is None:
            if generator is None:
                raise ValueError("pass z_eps (noise) or a torch.Generator")
            z_eps = torch.randn(
                prior_mu.shape, generator=generator, dtype=torch.float32,
                device=generator.device,
            ).to(prior_mu.device)
        # the reparameterized sample from q (training) or the prior: float32
        # noise promotes it, and XLA's bfloat16 exp feeds it unrounded
        mu, logvar = (prior_mu, prior_logvar) if q_mu is None else (q_mu, q_logvar)
        z = mu + z_eps.to(torch.float32) * torch.exp(0.5 * logvar.float())

        gen = self.generator(torch.cat([z.to(cfg.dtype), cond], dim=-1))
        gen = gen.reshape(*gen.shape[:-1], cfg.num_gen_points, 3)
        generated = gen.float() + center[:, :, None, :]
        objectness = self.objectness(cond)[..., 0].float()
        f32 = [None if v is None else v.float() for v in (prior_mu, prior_logvar, q_mu, q_logvar)]
        return GSPNOutputs(center, generated, objectness, f32[0], f32[1], cond, f32[2], f32[3])


# ---------------------------------------------------------------------------
# Losses (gspn_tpu/models/gspn.py:272-376)
# ---------------------------------------------------------------------------


def kl_gaussians(mu_q, logvar_q, mu_p, logvar_p):
    """KL(q || p) between diagonal Gaussians, summed over the latent axis."""
    var_q = torch.exp(logvar_q)
    var_p = torch.exp(logvar_p)
    kl = 0.5 * (logvar_p - logvar_q + (var_q + (mu_q - mu_p) ** 2) / var_p - 1.0)
    return kl.sum(dim=-1)


def huber(x, delta: float = 1.0):
    a = torch.abs(x)
    return torch.where(a <= delta, 0.5 * x * x, delta * (a - 0.5 * delta))


def optax_sigmoid_bce(logits, labels):
    """Binary cross-entropy on logits, ``-y log p - (1 - y) log(1 - p)`` with
    both logs by ``logsigmoid`` (the JAX package's inline copy of optax's
    ``sigmoid_binary_cross_entropy``)."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def masked_chamfer(pred, gt, gt_valid, impl: str = "auto"):
    """Per-seed symmetric chamfer: ``pred (B,S,G,3)``, ``gt (B,S,Ggt,3)``
    with ``gt_valid (B,S,Ggt)`` -> ``(B,S)``."""
    b, s, g, _ = pred.shape
    p = pred.reshape(b * s, g, 3)
    t = gt.reshape(b * s, gt.shape[2], 3)
    v = gt_valid.reshape(b * s, gt.shape[2])
    d1, _, d2, _ = ops.nn_distance(p, t, valid2=v, impl=impl)
    l1 = d1.mean(dim=-1)
    w = v.to(d2.dtype)
    l2 = (d2 * w).sum(dim=-1) / torch.clamp(w.sum(dim=-1), min=1.0)
    return (l1 + l2).reshape(b, s)


def gspn_loss(out: GSPNOutputs, gt_points, gt_valid, gt_center, seed_objectness,
              seed_valid=None, kl_weight: float = 1.0, center_weight: float = 1.0,
              obj_weight: float = 1.0, chamfer_weight: float = 1.0, impl: str = "auto",
              group=None):
    """Total CVAE loss and its terms ``{"loss", "chamfer", "kl", "center",
    "objectness"}`` (0-dim tensors). Chamfer, KL and centre Huber are
    averaged over the seeds on an instance (``seed_objectness``); the
    objectness BCE over every valid seed, as in the reference.

    ``group``: a process group whose ranks hold the other shards of the
    batch (the JAX package's ``axis_name``): the numerators and seed counts
    are summed over its ranks (``all_reduce_sum``), so every rank computes
    the same global loss."""
    if out.q_mu is None:
        raise ValueError("gspn_loss needs the recognition network's outputs (training)")
    pos = seed_objectness.to(torch.float32)
    if seed_valid is not None:
        sv = seed_valid.to(torch.float32)
        pos = pos * sv
    else:
        sv = torch.ones_like(pos)
    ch = masked_chamfer(out.generated, gt_points, gt_valid, impl)
    kl = kl_gaussians(out.q_mu, out.q_logvar, out.prior_mu, out.prior_logvar)
    cerr = huber(out.center - gt_center).sum(dim=-1)
    obj_bce = optax_sigmoid_bce(out.objectness, seed_objectness.to(torch.float32))
    sums = (pos.sum(), sv.sum(), (ch * pos).sum(), (kl * pos).sum(), (cerr * pos).sum(),
            (obj_bce * sv).sum())
    if group is not None:
        sums = all_reduce_sum(torch.stack(sums), group).unbind()
    npos_raw, nval_raw, ch_sum, kl_sum, cen_sum, obj_sum = sums
    npos = torch.clamp(npos_raw, min=1.0)
    nval = torch.clamp(nval_raw, min=1.0)
    chamfer_term = ch_sum / npos
    kl_term = kl_sum / npos
    center_term = cen_sum / npos
    obj_term = obj_sum / nval
    total = (chamfer_weight * chamfer_term + kl_weight * kl_term
             + center_weight * center_term + obj_weight * obj_term)
    return total, {"loss": total, "chamfer": chamfer_term, "kl": kl_term,
                   "center": center_term, "objectness": obj_term}


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
