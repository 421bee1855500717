"""Full-scene instance-segmentation inference: GSPN proposals -> NMS ->
Point RoIAlign -> heads -> per-point masks. The PyTorch counterpart of
``gspn_tpu/models/pipeline.py`` for the configuration this port runs:
exact or segmented FPS shared by the seeds and backbone sa1, exact FP
interpolation, and ``mask_project="3nn"``.

Weights live in a :class:`PipelineModel` (``gspn`` and ``rpointnet``
submodules named as the Flax variable trees); its state dict comes from
:func:`init_pipeline_variables` (seeded) or from JAX variables through
``gspn_tpu_torch.convert``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from gspn_tpu_torch import ops
from gspn_tpu_torch.models.gspn import (
    GSPN,
    KNOB_PATHS,
    GSPNConfig,
    check_stage_config,
    not_ported,
    proposal_boxes,
)
from gspn_tpu_torch.models.rpointnet import RPointNet, RPointNetConfig, apply_box_deltas


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Same names and defaults as the JAX package's ``PipelineConfig``.
    ``mask_project`` defaults to "1nn" there too; this port runs only
    "3nn" so far and raises for the rest."""

    gspn: GSPNConfig = GSPNConfig()
    rpointnet: RPointNetConfig = RPointNetConfig()
    num_seeds: int = 128
    score_thresh: float = 0.05
    mask_thresh: float = 0.5
    box_percentile: float = 0.0
    mask_project: str = "1nn"
    sa1_fps_segments: int = 0
    mask_project_prune: str = "off"


@dataclasses.dataclass
class InstancePredictions:
    """Fixed-shape per-scene predictions (R proposal slots)."""

    masks: torch.Tensor  # (B, R, N) bool
    scores: torch.Tensor  # (B, R) f32: objectness * class probability
    classes: torch.Tensor  # (B, R) int32, 1..C
    boxes: torch.Tensor  # (B, R, 6) refined boxes
    valid: torch.Tensor  # (B, R) bool: survives NMS and the score threshold


def check_supported(cfg: PipelineConfig) -> None:
    """Raise ``NotImplementedError`` for every knob this port does not run."""
    if cfg.mask_project != "3nn":
        raise not_ported(
            f"mask_project={cfg.mask_project!r}",
            "ROADMAP.md queue 2 kernel 8, mask_project.py::_mask_project_kernel",
        )
    if cfg.mask_project_prune != "off":
        raise not_ported(
            f"mask_project_prune={cfg.mask_project_prune!r}",
            "ROADMAP.md queue 2 kernel 9, mask_project.py::_mask_project_boxed_kernel",
        )
    if cfg.sa1_fps_segments > 0:
        raise not_ported("sa1_fps_segments>0 (split FPS passes)", KNOB_PATHS)
    check_stage_config(cfg.gspn)
    check_stage_config(cfg.rpointnet)
    if cfg.rpointnet.roi_sample != "inbox":
        raise not_ported(f"roi_sample={cfg.rpointnet.roi_sample!r}", KNOB_PATHS)


def project_roi_masks(xyz, boxes, roi_xyz, mask_logits, mask_thresh, valid=None,
                      impl: str = "auto", mode: str = "3nn"):
    """Per-point masks ``(B, R, N)`` bool: a scene point belongs to RoI r when
    it lies inside the refined box and the inverse-distance-weighted logit
    of its 3 nearest RoI samples (``roi_xyz (B,R,S,3)``) passes
    ``mask_thresh`` after a sigmoid."""
    if mode != "3nn":
        raise not_ported(
            f"mask projection mode {mode!r}",
            "ROADMAP.md queue 2 kernel 8, mask_project.py::_mask_project_kernel",
        )
    b, r, s, _ = roi_xyz.shape
    n = xyz.shape[1]
    inside = ops.box_contains(boxes, xyz, valid)
    targets = xyz[:, None].expand(b, r, n, 3).reshape(b * r, n, 3)
    dist, idx3 = ops.three_nn(targets, roi_xyz.reshape(b * r, s, 3), impl=impl)
    w = ops.three_interpolate_weights(dist)
    logit = ops.three_interpolate(mask_logits.reshape(b * r, s, 1), idx3, w).reshape(b, r, n)
    return inside & (torch.sigmoid(logit) > mask_thresh)


def shared_fps_indices(cfg: PipelineConfig, xyz, valid):
    """``(seed_idx, sa1_fps_idx or None)``: greedy FPS is prefix-consistent,
    so ONE pass serves the proposal seeds and the backbone's sa1 when both
    stages sample the same way (at multiples of the segment count for a
    segmented pass). The spatial mode Morton-sorts once and runs contiguous
    chains over the sorted view (``gspn_tpu`` ``shared_fps_indices_view``)."""
    if cfg.sa1_fps_segments:
        raise not_ported("sa1_fps_segments>0 (split FPS passes)", KNOB_PATHS)
    g, rp = cfg.gspn, cfg.rpointnet
    sa1_n = rp.sa_layers[0].npoint
    n = xyz.shape[1]
    if (
        g.ops_impl == rp.ops_impl
        and g.fps_segments == rp.fps_segments
        and g.fps_segment_mode == rp.fps_segment_mode
    ):
        segs = ops.shared_eligible_fps_segments(g.fps_segments, (cfg.num_seeds, sa1_n), n)
        total = max(cfg.num_seeds, sa1_n)
        if segs > 1 and g.fps_segment_mode == "spatial":
            sxyz, svalid, sidx = ops.spatial_sorted_view(xyz, valid)
            pos = ops.farthest_point_sample(
                total, sxyz, svalid, impl=g.ops_impl, segments=segs,
                segment_mode="contiguous",
            )
            fps_all = torch.gather(sidx, 1, pos.long())
        else:
            fps_all = ops.farthest_point_sample(
                total, xyz, valid, impl=g.ops_impl, segments=segs,
                segment_mode=g.fps_segment_mode,
            )
        return fps_all[:, : cfg.num_seeds], fps_all[:, :sa1_n]
    seed_idx = ops.farthest_point_sample(
        cfg.num_seeds, xyz, valid, impl=g.ops_impl,
        segments=ops.eligible_fps_segments(g.fps_segments, cfg.num_seeds, n),
        segment_mode=g.fps_segment_mode,
    )
    return seed_idx, None  # the backbone samples with its own settings


class PipelineModel(nn.Module):
    """Both stages' weights: ``gspn`` and ``rpointnet``."""

    def __init__(self, cfg: PipelineConfig):
        super().__init__()
        self.gspn = GSPN(cfg.gspn)
        self.rpointnet = RPointNet(cfg.rpointnet)


def make_inference_fn(cfg: PipelineConfig):
    """Returns ``infer(model, xyz, valid=None, z_eps=None, generator=None)
    -> InstancePredictions`` for a :class:`PipelineModel` in eval mode.
    ``z_eps (B, num_seeds, latent_dim)`` is the CVAE noise; without it the
    noise is drawn from ``generator``.

    Float32 matrix products are assumed to stay float32 (torch's default;
    a TF32 product can flip a mask threshold): callers that enable TF32 get
    different masks. ``utils.bench_slice.float32_matmuls`` pins it."""
    check_supported(cfg)

    def infer(model: PipelineModel, xyz, valid=None, z_eps=None, generator=None):
        seed_idx, sa1_idx = shared_fps_indices(cfg, xyz, valid)
        gout = model.gspn(xyz, seed_idx, valid, z_eps=z_eps, generator=generator)
        boxes = proposal_boxes(gout.generated, cfg.rpointnet.box_margin, cfg.box_percentile)
        obj = torch.sigmoid(gout.objectness)
        keep = ops.nms_3d_batched(boxes, obj, cfg.rpointnet.nms_iou)

        out = model.rpointnet(xyz, boxes, valid, sa1_fps_idx=sa1_idx)
        fg_prob = torch.softmax(out.cls_logits, dim=-1)[..., 1:]  # drop background
        cls = (fg_prob.argmax(dim=-1) + 1).to(torch.int32)
        score = obj * fg_prob.amax(dim=-1)
        refined = apply_box_deltas(boxes, out.box_deltas)

        pvalid = keep & out.roi_valid & (score > cfg.score_thresh)
        masks = project_roi_masks(
            xyz, refined, out.roi_xyz, out.mask_logits, cfg.mask_thresh, valid,
            impl=cfg.rpointnet.ops_impl, mode=cfg.mask_project,
        )
        masks = masks & pvalid[..., None]
        return InstancePredictions(
            masks=masks,
            scores=torch.where(pvalid, score, torch.zeros_like(score)),
            classes=cls,
            boxes=refined,
            valid=pvalid,
        )

    return infer


def _glorot_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    fan_out, fan_in = w.shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)


def init_pipeline_variables(cfg: PipelineConfig, generator: torch.Generator, n: int):
    """Seeded weights for both stages as a :class:`PipelineModel` state dict,
    initialized as the JAX package initializes them: glorot-uniform Linear
    weights, zero biases, BatchNorm scale 1 / bias 0 / mean 0 / var 1.

    ``n`` (points per scene) is kept for signature parity with the JAX
    function, which traces dummy inputs of that size; no width here depends
    on it. The draws come from ``generator`` in module order, so they are
    reproducible but are not the JAX package's numbers."""
    del n
    model = PipelineModel(cfg)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            _glorot_uniform_(mod.weight, generator)
            nn.init.zeros_(mod.bias)
    return model.state_dict()
