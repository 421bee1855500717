"""R-PointNet instance segmentation over proposals, inference forward: the
PyTorch counterpart of ``gspn_tpu/models/rpointnet.py``.

Backbone (PointNet++ SA x k + FP x k), Point RoIAlign, and the heads
(classification, box refinement, per-sample mask logits). RoIAlign is
``roi_sample="inbox"`` (the first S scene points in each box, cycled when
fewer) or ``"grid"`` (S free points on a cell-centre grid in each box,
features interpolated from their three nearest scene points). Matching and
losses are training-only and not ported.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from gspn_tpu_torch import ops
from gspn_tpu_torch.models.gspn import check_stage_config
from gspn_tpu_torch.nn.layers import FCLayers, PointMLP
from gspn_tpu_torch.nn.pointnet2 import PointNetFPModule, PointNetSAModule


@dataclasses.dataclass(frozen=True)
class SALayerSpec:
    npoint: int
    radius: float
    nsample: int
    mlp: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class RPointNetConfig:
    """Same names and defaults as the JAX package's ``RPointNetConfig``
    (training-only fields left out)."""

    sa_layers: tuple[SALayerSpec, ...] = (
        SALayerSpec(1024, 0.1, 32, (32, 32, 64)),
        SALayerSpec(256, 0.2, 32, (64, 64, 128)),
        SALayerSpec(64, 0.4, 32, (128, 128, 256)),
        SALayerSpec(16, 0.8, 32, (256, 256, 512)),
    )
    fp_mlps: tuple[tuple[int, ...], ...] = (
        (256, 256),
        (256, 256),
        (256, 128),
        (128, 128, 128),
    )
    feature_dim: int = 0
    roi_samples: int = 64
    roi_sample: str = "inbox"
    roi_mlp: tuple[int, ...] = (128, 256)
    cls_fc: tuple[int, ...] = (256, 128)
    box_fc: tuple[int, ...] = (256, 128)
    mask_mlp: tuple[int, ...] = (128, 128)
    num_classes: int = 18
    nms_iou: float = 0.25
    box_margin: float = 0.1
    use_bn: bool = True
    ops_impl: str = "auto"  # auto|cuda|plain (ops/common.py)
    fps_segments: int = 1
    fps_segment_mode: str = "contiguous"
    group_select: str = "first"
    dtype: torch.dtype = torch.float32


class Backbone(nn.Module):
    """PointNet++ SA x k + FP x k -> per-point features ``(B, N, C)``."""

    def __init__(self, config: RPointNetConfig):
        super().__init__()
        cfg = self.config = config
        chans = [0]  # feature channels per level (level 0: no input features)
        for i, spec in enumerate(cfg.sa_layers):
            self.add_module(
                f"sa{i + 1}",
                PointNetSAModule(
                    3 + chans[-1], spec.npoint, spec.radius, spec.nsample, spec.mlp,
                    use_bn=cfg.use_bn, ops_impl=cfg.ops_impl,
                    fps_segments=cfg.fps_segments,
                    fps_segment_mode=cfg.fps_segment_mode, select=cfg.group_select,
                ),
            )
            chans.append(spec.mlp[-1])
        feat = chans[-1]
        for i, mlp in enumerate(cfg.fp_mlps):
            lvl = len(cfg.sa_layers) - 1 - i  # target level
            self.add_module(
                f"fp{i + 1}",
                PointNetFPModule(feat + chans[lvl], mlp, use_bn=cfg.use_bn, ops_impl=cfg.ops_impl),
            )
            feat = mlp[-1]

    def forward(self, xyz, valid=None, sa1_fps_idx=None):
        cfg = self.config
        xs, fs, vs = [xyz], [None], [valid]
        for i in range(len(cfg.sa_layers)):
            nx, nf, nv = getattr(self, f"sa{i + 1}")(
                xs[-1], fs[-1], vs[-1], sa1_fps_idx if i == 0 else None
            )
            xs.append(nx)
            fs.append(nf)
            vs.append(nv)
        feat = fs[-1]
        for i in range(len(cfg.fp_mlps)):
            lvl = len(cfg.sa_layers) - 1 - i
            feat = getattr(self, f"fp{i + 1}")(
                xs[lvl], xs[lvl + 1], fs[lvl], feat, vs[lvl], vs[lvl + 1]
            )
        return feat


def point_roi_align(xyz, boxes, s: int, valid=None, impl: str = "auto", select: str = "first"):
    """The first ``s`` scene points inside each box (cycling ``k mod cnt``
    when the box holds fewer), in the RoI frame scaled by the box extent.

    ``xyz (B,N,3)``, ``boxes (B,R,6)`` -> ``(idx (B,R,S) int32, canon
    (B,R,S,3), roi_valid (B,R) bool, in_cnt (B,R) int32)``."""
    extent = torch.clamp(boxes[..., 3:6] - boxes[..., 0:3], min=1e-6)
    first_s, cnt, local = ops.query_box_group(boxes, s, xyz, valid, impl=impl, select=select)
    k = torch.arange(s, dtype=torch.int32, device=xyz.device)
    wrap = torch.remainder(k, torch.clamp(cnt, min=1)[..., None]).long()  # (B, R, S)
    idx = torch.gather(first_s, -1, wrap)
    roi_valid = cnt > 0
    idx = torch.where(roi_valid[..., None], idx, torch.zeros_like(idx))
    canon = torch.gather(local, -2, wrap[..., None].expand(-1, -1, -1, 3)) / extent[..., None, :]
    return idx, canon, roi_valid, cnt


def _grid_factors(s: int) -> tuple[int, int, int]:
    """Near-cubic ``(gx, gy, gz)`` with ``gx * gy * gz == s`` (64 -> 4x4x4)."""
    best = (1, 1, s)
    for gx in range(1, int(round(s ** (1 / 3))) + 2):
        if s % gx:
            continue
        rem = s // gx
        for gy in range(gx, int(rem ** 0.5) + 2):
            if rem % gy:
                continue
            gz = rem // gy
            if max(gx, gy, gz) - min(gx, gy, gz) <= max(*best) - min(*best):
                best = (gx, gy, gz)
    return best


def roi_grid_points(boxes, s: int):
    """``s`` free points on a canonical cell-centre grid inside each box:
    ``boxes (B,R,6)`` -> ``(world (B,R,S,3), canon (B,R,S,3))``; ``canon``
    (cell centres in [-0.5, 0.5]^3) is the same for every RoI."""
    dev = boxes.device
    axes = []
    for g in _grid_factors(s):
        gt = torch.full((g,), g, dtype=torch.float32, device=dev)  # a true division
        axes.append((torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / gt - 0.5)
    canon = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(s, 3)
    center = (boxes[..., 0:3] + boxes[..., 3:6]) * 0.5
    extent = torch.clamp(boxes[..., 3:6] - boxes[..., 0:3], min=1e-6)
    world = center[..., None, :] + canon * extent[..., None, :]
    return world, canon.expand(world.shape)


def interpolate_roi_features(xyz, features, world, valid=None, impl: str = "auto"):
    """Backbone features at free RoI points by three_nn and exact
    inverse-distance interpolation: ``xyz (B,N,3)``, ``features (B,N,C)``,
    ``world (B,R,S,3)`` -> ``(feats (B,R,S,C), nearest scene point (B,R,S)
    int32)``."""
    b, r, s, _ = world.shape
    dist, idx3 = ops.three_nn(world.reshape(b, r * s, 3), xyz, valid, impl=impl)
    feats = ops.three_interpolate(features, idx3, ops.three_interpolate_weights(dist))
    return feats.reshape(b, r, s, features.shape[-1]), idx3[..., 0].reshape(b, r, s)


@dataclasses.dataclass
class RoIOutputs:
    cls_logits: torch.Tensor  # (B, R, num_classes + 1); class 0 = background
    box_deltas: torch.Tensor  # (B, R, 6)
    mask_logits: torch.Tensor  # (B, R, S)
    roi_idx: torch.Tensor  # (B, R, S) scene index of each sample ("grid": its nearest)
    roi_xyz: torch.Tensor  # (B, R, S, 3) world coordinates of the samples
    roi_valid: torch.Tensor  # (B, R) bool


class RoIHeads(nn.Module):
    def __init__(self, config: RPointNetConfig, feat_dim: int):
        super().__init__()
        cfg = config
        self.roi_mlp = PointMLP(3 + feat_dim, cfg.roi_mlp, use_bn=cfg.use_bn)
        c = cfg.roi_mlp[-1]
        self.cls = FCLayers(c, cfg.cls_fc, cfg.num_classes + 1)
        self.box = FCLayers(c, cfg.box_fc, 6)
        self.mask_mlp = PointMLP(2 * c, cfg.mask_mlp, use_bn=cfg.use_bn)
        self.mask_out = nn.Linear(cfg.mask_mlp[-1], 1)

    def forward(self, canon, roi_feats):
        """``canon (B,R,S,3)``, ``roi_feats (B,R,S,C)`` -> ``(cls_logits,
        box_deltas, mask_logits)``."""
        pt = self.roi_mlp(torch.cat([canon, roi_feats], dim=-1))  # (B, R, S, C')
        pooled = pt.amax(dim=-2)
        cls_logits = self.cls(pooled)
        box_deltas = self.box(pooled)
        per_pt = torch.cat([pt, pooled[..., None, :].expand_as(pt)], dim=-1)
        mask_logits = self.mask_out(self.mask_mlp(per_pt))[..., 0]
        return cls_logits, box_deltas, mask_logits


class RPointNet(nn.Module):
    """Backbone + Point RoIAlign + heads."""

    def __init__(self, config: RPointNetConfig = RPointNetConfig()):
        super().__init__()
        check_stage_config(config)
        if config.roi_sample not in ("inbox", "grid"):
            raise ValueError(f"roi_sample must be inbox|grid, got {config.roi_sample!r}")
        self.config = config
        self.backbone = Backbone(config)
        self.heads = RoIHeads(config, config.fp_mlps[-1][-1])

    def forward(self, xyz, boxes, valid=None, sa1_fps_idx=None) -> RoIOutputs:
        cfg = self.config
        feat = self.backbone(xyz, valid, sa1_fps_idx)
        if cfg.roi_sample == "grid":
            roi_xyz, canon = roi_grid_points(boxes, cfg.roi_samples)
            roi_feats, idx = interpolate_roi_features(xyz, feat, roi_xyz, valid, impl=cfg.ops_impl)
            roi_valid = ops.box_contains(boxes, xyz, valid).any(dim=-1)
        else:
            idx, canon, roi_valid, _ = point_roi_align(
                xyz, boxes, cfg.roi_samples, valid, impl=cfg.ops_impl, select=cfg.group_select
            )
            roi_feats = ops.group_point(feat, idx, impl=cfg.ops_impl)
            roi_xyz = ops.group_point(xyz, idx, impl=cfg.ops_impl)
        cls_logits, box_deltas, mask_logits = self.heads(canon, roi_feats)
        cls_logits = torch.where(roi_valid[..., None], cls_logits, torch.zeros_like(cls_logits))
        mask_logits = torch.where(
            roi_valid[..., None], mask_logits, torch.full_like(mask_logits, -1e4)
        )
        return RoIOutputs(cls_logits, box_deltas, mask_logits, idx, roi_xyz, roi_valid)


def apply_box_deltas(boxes, deltas):
    """Refine boxes: deltas = (centre offset in extent units, log-extent)."""
    center = (boxes[..., 0:3] + boxes[..., 3:6]) * 0.5
    extent = torch.clamp(boxes[..., 3:6] - boxes[..., 0:3], min=1e-6)
    new_center = center + deltas[..., 0:3] * extent
    new_extent = extent * torch.exp(torch.clamp(deltas[..., 3:6], -4.0, 4.0))
    return torch.cat([new_center - new_extent / 2, new_center + new_extent / 2], dim=-1)
