"""R-PointNet instance segmentation over proposals: the PyTorch counterpart
of ``gspn_tpu/models/rpointnet.py``.

Backbone (PointNet++ SA x k + FP x k), Point RoIAlign, and the heads
(classification, box refinement, per-sample mask logits). RoIAlign is
``roi_sample="inbox"`` (the first S scene points in each box, cycled when
fewer; in training with ``roi_randomize``, a uniform random subset of them
by a Gumbel top-k) or ``"grid"`` (S free points on a cell-centre grid in
each box, features interpolated from their three nearest scene points).
Training (``model.train()``) also applies ``head_dropout`` in the
classification and box heads. For the stage-2 loss: GT boxes from the
per-point labels (:func:`instance_gt_boxes`), IoU matching of RoIs to them
(:func:`match_rois`) and :func:`rpointnet_loss`.

``feature_dim > 0``: the backbone's first SA groups the per-point input
features beside the local coordinates. ``dtype``: the backbone's, the RoI
MLP's and the heads' compute dtype (``nn.layers``); the heads' outputs are
float32.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gspn_tpu_torch import ops
from gspn_tpu_torch.models.gspn import check_stage_config, huber
from gspn_tpu_torch.nn.layers import (
    Dense, FCLayers, MaskedBatchNorm, PointMLP, all_reduce_sum, running_statistics_held,
)
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
    (its mesh-axis field left out: the port's BatchNorm takes a process
    group, ``nn.layers.cross_rank_statistics``)."""

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
    # "inbox" in training only: a uniform random subset of the in-box
    # points (Gumbel top-k) in place of the first S
    roi_randomize: bool = False
    roi_mlp: tuple[int, ...] = (128, 256)
    cls_fc: tuple[int, ...] = (256, 128)
    box_fc: tuple[int, ...] = (256, 128)
    mask_mlp: tuple[int, ...] = (128, 128)
    num_classes: int = 18
    head_dropout: float = 0.0  # dropout rate in the cls/box FC heads (training)
    fg_iou: float = 0.5  # matching: a RoI is foreground from this IoU up
    bg_iou: float = 0.25  # and background below this one
    nms_iou: float = 0.25
    box_margin: float = 0.1
    use_bn: bool = True
    # rematerialize each SA and FP module in training: its activations are
    # recomputed in backward instead of kept (less memory, more time)
    remat: bool = False
    ops_impl: str = "auto"  # auto|cuda|plain (ops/common.py)
    fps_segments: int = 1
    fps_segment_mode: str = "contiguous"
    group_select: str = "first"
    dtype: torch.dtype = torch.float32


@contextlib.contextmanager
def _recompute_as(bns, groups):
    """The recompute of a rematerialized module: its BatchNorms' process
    groups as the forward saw them, their running statistics held."""
    before = [m.group for m in bns]
    for m, g in zip(bns, groups, strict=True):
        m.group = g
    try:
        with running_statistics_held():
            yield
    finally:
        for m, g in zip(bns, before, strict=True):
            m.group = g


def _remat(module: nn.Module, *args):
    """``module(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    only the inputs are kept, and backward runs the forward again, with the
    BatchNorms' process groups of this call and without blending their
    running statistics a second time. The SA and FP modules draw no
    random numbers, so no generator state is stashed."""
    bns = [m for m in module.modules() if isinstance(m, MaskedBatchNorm)]
    groups = [m.group for m in bns]
    return checkpoint(module, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recompute_as(bns, groups)))


class Backbone(nn.Module):
    """PointNet++ SA x k + FP x k -> per-point features ``(B, N, C)``.
    With the config's ``remat``, each SA and FP module runs rematerialized
    in training while gradients are on (:func:`_remat`), as the JAX
    package's ``nn.remat``: the same values, less memory held for
    backward."""

    def __init__(self, config: RPointNetConfig):
        super().__init__()
        cfg = self.config = config
        chans = [cfg.feature_dim]  # feature channels per level (level 0: the input's)
        for i, spec in enumerate(cfg.sa_layers):
            self.add_module(
                f"sa{i + 1}",
                PointNetSAModule(
                    3 + chans[-1], spec.npoint, spec.radius, spec.nsample, spec.mlp,
                    use_bn=cfg.use_bn, ops_impl=cfg.ops_impl,
                    fps_segments=cfg.fps_segments,
                    fps_segment_mode=cfg.fps_segment_mode, select=cfg.group_select,
                    dtype=cfg.dtype,
                ),
            )
            chans.append(spec.mlp[-1])
        feat = chans[-1]
        for i, mlp in enumerate(cfg.fp_mlps):
            lvl = len(cfg.sa_layers) - 1 - i  # target level
            self.add_module(
                f"fp{i + 1}",
                PointNetFPModule(feat + chans[lvl], mlp, use_bn=cfg.use_bn,
                                 ops_impl=cfg.ops_impl, dtype=cfg.dtype),
            )
            feat = mlp[-1]

    def forward(self, xyz, valid=None, sa1_fps_idx=None, features=None):
        """``features (B,N,F)``: the per-point input features, read when
        ``feature_dim > 0``."""
        cfg = self.config
        if cfg.feature_dim > 0 and features is None:
            raise ValueError(f"the config has feature_dim={cfg.feature_dim}: pass features")
        remat = cfg.remat and self.training and torch.is_grad_enabled()

        def run(module, *args):
            return _remat(module, *args) if remat else module(*args)

        xs, fs, vs = [xyz], [features if cfg.feature_dim > 0 else None], [valid]
        for i in range(len(cfg.sa_layers)):
            nx, nf, nv = run(getattr(self, f"sa{i + 1}"),
                             xs[-1], fs[-1], vs[-1], sa1_fps_idx if i == 0 else None)
            xs.append(nx)
            fs.append(nf)
            vs.append(nv)
        feat = fs[-1]
        for i in range(len(cfg.fp_mlps)):
            lvl = len(cfg.sa_layers) - 1 - i
            feat = run(getattr(self, f"fp{i + 1}"),
                       xs[lvl], xs[lvl + 1], fs[lvl], feat, vs[lvl], vs[lvl + 1])
        return feat


def point_roi_align(xyz, boxes, s: int, valid=None, impl: str = "auto", select: str = "first",
                    gumbel=None, generator=None, randomize: bool = False):
    """``s`` scene points inside each box (cycling ``k mod cnt`` when the
    box holds fewer), in the RoI frame scaled by the box extent.

    By default the first ``s`` in input order (``ops.query_box_group``).
    With ``randomize``, a uniform random in-box subset without replacement
    (the reference's randomized RoI sampling): the top ``s`` of Gumbel noise
    ``gumbel (B,R,N)`` over the in-box points, drawn from ``generator`` as
    ``jax.random.gumbel`` draws it when not given; ``in_cnt`` is then
    capped at ``s``, as in the JAX package.

    ``xyz (B,N,3)``, ``boxes (B,R,6)`` -> ``(idx (B,R,S) int32, canon
    (B,R,S,3), roi_valid (B,R) bool, in_cnt (B,R) int32)``."""
    extent = torch.clamp(boxes[..., 3:6] - boxes[..., 0:3], min=1e-6)
    if randomize:
        inside = ops.box_contains(boxes, xyz, valid)  # (B, R, N)
        if gumbel is None:
            gumbel = gumbel_noise(inside.shape, generator)
        gumbel = gumbel.to(xyz.device)
        keyed = torch.where(inside, gumbel, torch.full_like(gumbel, -torch.inf))
        first_s = torch.topk(keyed, s, dim=-1, sorted=True).indices.to(torch.int32)
        cnt = inside.sum(dim=-1, dtype=torch.int32)
    else:
        first_s, cnt, local = ops.query_box_group(boxes, s, xyz, valid, impl=impl, select=select)
    k = torch.arange(s, dtype=torch.int32, device=xyz.device)
    wrap = torch.remainder(k, torch.clamp(cnt, min=1)[..., None]).long()  # (B, R, S)
    idx = torch.gather(first_s, -1, wrap)
    roi_valid = cnt > 0
    idx = torch.where(roi_valid[..., None], idx, torch.zeros_like(idx))
    if not randomize:
        canon = torch.gather(local, -2, wrap[..., None].expand(-1, -1, -1, 3)) / extent[..., None, :]
        return idx, canon, roi_valid, cnt
    b, r, _ = idx.shape
    pts = ops.gather_point(xyz, idx.reshape(b, r * s), impl=impl).reshape(b, r, s, 3)
    center = (boxes[..., 0:3] + boxes[..., 3:6]) * 0.5
    canon = (pts - center[..., None, :]) / extent[..., None, :]
    return idx, canon, roi_valid, torch.clamp(cnt, max=s)


def gather_roi_features(features, idx, impl: str = "auto"):
    """``features (B,N,C)`` at the RoI samples ``idx (B,R,S)`` -> ``(B,R,S,C)``:
    ``ops.group_point``, whose gradient sums in a fixed order on the card."""
    return ops.group_point(features, idx, impl=impl)


def gumbel_noise(shape, generator: torch.Generator | None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` with ``u`` uniform in
    ``[tiny, 1)``, as ``jax.random.gumbel`` draws it, from ``generator``."""
    if generator is None:
        raise ValueError("randomized RoI sampling needs Gumbel noise or a torch.Generator")
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=generator.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


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
    feats = ops.three_interpolate(features, idx3, ops.three_interpolate_weights(dist), impl=impl)
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
        cfg, dt = config, config.dtype
        self.roi_mlp = PointMLP(3 + feat_dim, cfg.roi_mlp, use_bn=cfg.use_bn, dtype=dt,
                                ops_impl=cfg.ops_impl)
        c = cfg.roi_mlp[-1]
        self.cls = FCLayers(c, cfg.cls_fc, cfg.num_classes + 1, dropout=cfg.head_dropout,
                            dtype=dt)
        self.box = FCLayers(c, cfg.box_fc, 6, dropout=cfg.head_dropout, dtype=dt)
        self.mask_mlp = PointMLP(2 * c, cfg.mask_mlp, use_bn=cfg.use_bn, dtype=dt,
                                 ops_impl=cfg.ops_impl)
        self.mask_out = Dense(cfg.mask_mlp[-1], 1, dtype=dt)

    def forward(self, canon, roi_feats, dropout_keep=None, generator=None):
        """``canon (B,R,S,3)``, ``roi_feats (B,R,S,C)`` -> ``(cls_logits,
        box_deltas, mask_logits)``. The point MLPs take no RoI mask, so in
        training their BatchNorm statistics include invalid RoIs, as in the
        JAX package. ``dropout_keep``: ``{"cls": [...], "box": [...]}``, each
        head's keep masks (``FCLayers.forward``), else drawn from
        ``generator``, the classification head's first."""
        keep = dropout_keep or {}
        pt = self.roi_mlp(torch.cat([canon, roi_feats], dim=-1))  # (B, R, S, C')
        pooled = pt.amax(dim=-2)
        cls_logits = self.cls(pooled, keep.get("cls"), generator)
        box_deltas = self.box(pooled, keep.get("box"), generator)
        per_pt = torch.cat([pt, pooled[..., None, :].expand_as(pt)], dim=-1)
        mask_logits = self.mask_out(self.mask_mlp(per_pt))[..., 0]
        return cls_logits.float(), box_deltas.float(), mask_logits.float()


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

    def forward(self, xyz, boxes, valid=None, sa1_fps_idx=None, gumbel=None,
                dropout_keep=None, generator=None, features=None) -> RoIOutputs:
        """In training mode with ``roi_randomize``, the RoIs' Gumbel noise
        ``gumbel (B,R,N)``, and with ``head_dropout``, the heads' keep masks
        ``dropout_keep`` (``RoIHeads.forward``); each not given is drawn from
        ``generator``, the Gumbel noise first. ``features (B,N,F)``: the
        per-point input features (``Backbone.forward``)."""
        feat = self.backbone(xyz, valid, sa1_fps_idx, features)
        return self.roi_forward(xyz, feat, boxes, valid, gumbel, dropout_keep, generator)

    def roi_forward(self, xyz, feat, boxes, valid=None, gumbel=None, dropout_keep=None,
                    generator=None) -> RoIOutputs:
        """Point RoIAlign of the backbone's map ``feat (B,N,C)`` at ``boxes``
        and the heads: :meth:`forward` after the backbone (the sharded
        pipelines run it on a rank's slice of the RoIs)."""
        cfg = self.config
        if cfg.roi_sample == "grid":
            roi_xyz, canon = roi_grid_points(boxes, cfg.roi_samples)
            roi_feats, idx = interpolate_roi_features(xyz, feat, roi_xyz, valid, impl=cfg.ops_impl)
            roi_valid = ops.box_contains(boxes, xyz, valid).any(dim=-1)
        else:
            idx, canon, roi_valid, _ = point_roi_align(
                xyz, boxes, cfg.roi_samples, valid, impl=cfg.ops_impl, select=cfg.group_select,
                gumbel=gumbel, generator=generator,
                randomize=cfg.roi_randomize and self.training,
            )
            roi_feats = gather_roi_features(feat, idx, cfg.ops_impl)
            roi_xyz = gather_roi_features(xyz, idx, cfg.ops_impl)
        cls_logits, box_deltas, mask_logits = self.heads(canon, roi_feats, dropout_keep, generator)
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


def box_deltas_between(src, dst):
    """The inverse of :func:`apply_box_deltas`: the regression target that
    takes ``src`` boxes to ``dst``."""
    sc = (src[..., 0:3] + src[..., 3:6]) * 0.5
    se = torch.clamp(src[..., 3:6] - src[..., 0:3], min=1e-6)
    dc = (dst[..., 0:3] + dst[..., 3:6]) * 0.5
    de = torch.clamp(dst[..., 3:6] - dst[..., 0:3], min=1e-6)
    return torch.cat([(dc - sc) / se, torch.log(de / se)], dim=-1)


def instance_gt_boxes(xyz, inst_label, sem_label, max_instances: int):
    """Each instance's GT box and class from the per-point labels (instance
    ``i`` has label ``i + 1``): ``boxes (B,I,6)`` (zeros where absent),
    ``cls (B,I)`` int32 (the largest semantic label among its points, 0
    where absent) and ``present (B,I)`` bool."""
    ids = torch.arange(1, max_instances + 1, dtype=inst_label.dtype, device=xyz.device)
    member = inst_label[:, None, :] == ids[None, :, None]  # (B, I, N)
    present = member.any(dim=-1)
    px = xyz[:, None, :, :]
    m = member[..., None]
    lo = torch.where(m, px, torch.full_like(px, 1e9)).amin(dim=2)
    hi = torch.where(m, px, torch.full_like(px, -1e9)).amax(dim=2)
    boxes = torch.where(present[..., None], torch.cat([lo, hi], dim=-1),
                        torch.zeros((), dtype=xyz.dtype, device=xyz.device))
    sem = torch.where(member, sem_label[:, None, :], torch.zeros_like(sem_label[:, None, :]))
    return boxes, sem.amax(dim=-1).to(torch.int32), present


@dataclasses.dataclass
class RoIMatch:
    matched_inst: torch.Tensor  # (B, R) int32 index into I (the IoU's argmax)
    matched_iou: torch.Tensor  # (B, R)
    is_fg: torch.Tensor  # (B, R) bool
    is_bg: torch.Tensor  # (B, R) bool
    cls_target: torch.Tensor  # (B, R) int32, 0 = background
    box_target: torch.Tensor  # (B, R, 6) deltas (meaningful on foreground)


def match_rois(rois, roi_valid, gt_boxes, gt_cls, gt_present, fg_iou: float, bg_iou: float):
    """IoU matching of RoI boxes to GT instance boxes: each RoI's best
    present instance (ties to the first), foreground from ``fg_iou`` up,
    background below ``bg_iou``, both only where ``roi_valid``."""
    iou = ops.box_iou(rois, gt_boxes)  # (B, R, I)
    iou = torch.where(gt_present[:, None, :], iou, torch.full_like(iou, -1.0))
    best = iou.amax(dim=-1)
    matched = iou.argmax(dim=-1)  # the first of equal maxima
    is_fg = (best >= fg_iou) & roi_valid
    is_bg = (best < bg_iou) & roi_valid
    cls_t = torch.where(is_fg, torch.gather(gt_cls, 1, matched), torch.zeros_like(gt_cls[:, :1]))
    mb = torch.gather(gt_boxes, 1, matched[..., None].expand(-1, -1, 6))  # (B, R, 6)
    return RoIMatch(
        matched_inst=matched.to(torch.int32), matched_iou=best, is_fg=is_fg, is_bg=is_bg,
        cls_target=cls_t.to(torch.int32), box_target=box_deltas_between(rois, mb),
    )


def rpointnet_loss(out: RoIOutputs, match: RoIMatch, inst_label, cls_weight: float = 1.0,
                   box_weight: float = 1.0, mask_weight: float = 1.0, group=None):
    """Softmax cross-entropy over foreground and background RoIs, the box
    deltas' Huber over foreground, and the per-sample mask BCE (the target:
    the sample's point belongs to the matched instance) over foreground.
    Returns ``(total, {"loss", "cls", "box", "mask", "num_fg", "num_bg"})``
    (0-dim tensors). ``group``: a process group whose ranks hold the other
    shards of the batch: the numerators and the foreground and background
    counts are summed over its ranks (``all_reduce_sum``), so every rank
    computes the same global loss."""
    train_mask = (match.is_fg | match.is_bg).to(torch.float32)
    fg = match.is_fg.to(torch.float32)

    logp = torch.log_softmax(out.cls_logits, dim=-1)
    ce = -torch.gather(logp, -1, match.cls_target.long()[..., None])[..., 0]
    box_err = huber(out.box_deltas - match.box_target).sum(dim=-1)

    b, r, s = out.roi_idx.shape
    pt_inst = torch.gather(inst_label, 1, out.roi_idx.reshape(b, r * s).long()).reshape(b, r, s)
    target = (pt_inst == (match.matched_inst[..., None] + 1)).to(torch.float32)
    logit = out.mask_logits
    bce = torch.clamp(logit, min=0.0) - logit * target + torch.log1p(torch.exp(-torch.abs(logit)))

    sums = (train_mask.sum(), fg.sum(), match.is_bg.to(torch.float32).sum(),
            (ce * train_mask).sum(), (box_err * fg).sum(), (bce.mean(dim=-1) * fg).sum())
    if group is not None:
        sums = all_reduce_sum(torch.stack(sums), group).unbind()
    ntr_raw, nfg_raw, nbg, cls_sum, box_sum, mask_sum = sums
    cls_term = cls_sum / torch.clamp(ntr_raw, min=1.0)
    nfg = torch.clamp(nfg_raw, min=1.0)
    box_term = box_sum / nfg
    mask_term = mask_sum / nfg
    total = cls_weight * cls_term + box_weight * box_term + mask_weight * mask_term
    return total, {"loss": total, "cls": cls_term, "box": box_term, "mask": mask_term,
                   "num_fg": nfg_raw, "num_bg": nbg}
