"""Full-scene instance-segmentation inference: GSPN proposals -> NMS ->
Point RoIAlign -> heads -> per-point masks. The PyTorch counterpart of
``gspn_tpu/models/pipeline.py``: exact or segmented FPS shared by the seeds
and backbone sa1 (or, with ``sa1_fps_segments > 0``, a pass each),
``mask_project`` "1nn" (nearest sample) or "3nn"
(inverse-distance weighted), and ``mask_project_prune="auto"`` (box-pruned
1-NN projection over the shared pass's Morton-sorted view).

:func:`make_streamed_inference_fn` runs T batches a call: on the card one
request captured in a CUDA graph and replayed T times.

Weights live in a :class:`PipelineModel` (``gspn`` and ``rpointnet``
submodules named as the Flax variable trees); its state dict comes from
:func:`init_pipeline_variables` (seeded) or from JAX variables through
``gspn_tpu_torch.convert``.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref

import torch
from torch import nn

from gspn_tpu_torch import ops
from gspn_tpu_torch.models.gspn import GSPN, GSPNConfig, check_stage_config, proposal_boxes
from gspn_tpu_torch.models.rpointnet import RPointNet, RPointNetConfig, apply_box_deltas
from gspn_tpu_torch.nn.layers import glorot_init_
from gspn_tpu_torch.utils.cuda_graph import GraphedRequest


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Same names and defaults as the JAX package's ``PipelineConfig``."""

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


PREDICTION_FIELDS = tuple(f.name for f in dataclasses.fields(InstancePredictions))


def check_supported(cfg: PipelineConfig) -> None:
    """Raise ``ValueError`` for a value no version takes and
    ``NotImplementedError`` for every knob this port does not run yet."""
    if cfg.mask_project not in ("1nn", "3nn"):
        raise ValueError(f"mask projection mode must be 1nn|3nn, got {cfg.mask_project!r}")
    if cfg.mask_project_prune not in ("auto", "off"):
        raise ValueError(f"mask_project_prune must be auto|off, got {cfg.mask_project_prune!r}")
    check_stage_config(cfg.gspn)
    check_stage_config(cfg.rpointnet)
    if cfg.rpointnet.roi_sample not in ("inbox", "grid"):
        raise ValueError(f"roi_sample must be inbox|grid, got {cfg.rpointnet.roi_sample!r}")


def _unpermute(mask_s, sidx):
    """``mask_s (B,R,N)`` over a sorted view back to the input order: input
    point ``p`` sits at sorted position ``inv[p]``, ``sidx[inv[p]] == p``."""
    b, r, n = mask_s.shape
    iota = torch.arange(n, dtype=torch.int64, device=sidx.device).expand(b, n)
    inv = torch.empty((b, n), dtype=torch.int64, device=sidx.device).scatter_(1, sidx.long(), iota)
    return torch.gather(mask_s, 2, inv[:, None, :].expand(b, r, n))


def project_roi_masks(xyz, boxes, roi_xyz, mask_logits, mask_thresh, valid=None,
                      impl: str = "auto", mode: str = "1nn", sorted_view=None):
    """Per-point masks ``(B, R, N)`` bool: a scene point belongs to RoI r when
    it lies inside the refined box and its projected logit passes
    ``mask_thresh`` after a sigmoid. ``roi_xyz (B,R,S,3)`` are the world
    coordinates of the RoI samples.

    ``mode="1nn"``: the nearest sample's logit (``ops.nearest_sample_logit``);
    ``"3nn"``: the inverse-distance-weighted logit of the 3 nearest samples.
    ``sorted_view=(sxyz, svalid, sidx)`` (``ops.spatial_sorted_view`` of
    ``xyz``/``valid``): "1nn" projects over the view with box pruning
    (``ops.nearest_sample_logit_boxed``) and unpermutes the masks; every
    valid in-box point's logit is the dense one, and the rest is ANDed
    away, so the masks are the same."""
    b, r, s, _ = roi_xyz.shape
    n = xyz.shape[1]
    if sorted_view is not None and mode == "1nn":
        sxyz, svalid, sidx = sorted_view
        inside_s = ops.box_contains(boxes, sxyz, svalid)
        logit_s = ops.nearest_sample_logit_boxed(
            sxyz, roi_xyz, mask_logits, boxes, point_valid=svalid, impl=impl
        )
        return _unpermute(inside_s & (torch.sigmoid(logit_s) > mask_thresh), sidx)

    inside = ops.box_contains(boxes, xyz, valid)
    if mode == "3nn":
        targets = xyz[:, None].expand(b, r, n, 3).reshape(b * r, n, 3)
        dist, idx3 = ops.three_nn(targets, roi_xyz.reshape(b * r, s, 3), impl=impl)
        w = ops.three_interpolate_weights(dist)
        logit = ops.three_interpolate(mask_logits.reshape(b * r, s, 1), idx3, w,
                                      impl=impl).reshape(b, r, n)
    elif mode == "1nn":
        logit = ops.nearest_sample_logit(xyz, roi_xyz, mask_logits, impl=impl)
    else:
        raise ValueError(f"mask projection mode must be 1nn|3nn, got {mode!r}")
    return inside & (torch.sigmoid(logit) > mask_thresh)


def shared_fps_indices_view(cfg: PipelineConfig, xyz, valid):
    """``(seed_idx, sa1_fps_idx or None, sorted_view or None)``: greedy FPS
    is prefix-consistent, so ONE pass serves the proposal seeds and the
    backbone's sa1 when both stages sample the same way (at multiples of
    the segment count for a segmented pass). The spatial mode Morton-sorts
    once, runs contiguous chains over the sorted view and returns the view
    ``(sxyz, svalid, sidx)`` for the box-pruned mask projection.

    An explicit ``sa1_fps_segments`` takes two passes
    (:func:`_split_fps_indices`) unless the shared pass already delivers
    sa1 at exactly that count: with ``sa1_fps_segments == fps_segments``
    but a seed-ineligible shared pass, the shared path would fall back to
    the exact FPS and ignore the count."""
    g, rp = cfg.gspn, cfg.rpointnet
    sa1_n = rp.sa_layers[0].npoint
    n = xyz.shape[1]
    same = (g.ops_impl == rp.ops_impl and g.fps_segments == rp.fps_segments
            and g.fps_segment_mode == rp.fps_segment_mode)
    if cfg.sa1_fps_segments:
        shared_ok = (
            same and cfg.sa1_fps_segments == g.fps_segments
            and ops.shared_eligible_fps_segments(g.fps_segments, (cfg.num_seeds, sa1_n), n)
            == cfg.sa1_fps_segments
        )
        if not shared_ok:
            return _split_fps_indices(cfg, xyz, valid, sa1_n, n)
    if same:
        segs = ops.shared_eligible_fps_segments(g.fps_segments, (cfg.num_seeds, sa1_n), n)
        total = max(cfg.num_seeds, sa1_n)
        view = None
        if segs > 1 and g.fps_segment_mode == "spatial":
            view = ops.spatial_sorted_view(xyz, valid)
            sxyz, svalid, sidx = view
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
        return fps_all[:, : cfg.num_seeds], fps_all[:, :sa1_n], view
    seed_idx = ops.farthest_point_sample(
        cfg.num_seeds, xyz, valid, impl=g.ops_impl,
        segments=ops.eligible_fps_segments(g.fps_segments, cfg.num_seeds, n),
        segment_mode=g.fps_segment_mode,
    )
    return seed_idx, None, None  # the backbone samples with its own settings


def _split_fps_indices(cfg: PipelineConfig, xyz, valid, sa1_n: int, n: int):
    """The seeds and sa1 in two FPS passes (``cfg.sa1_fps_segments > 0``):
    the seeds at the GSPN stage's segment count (capped by the seed count's
    eligibility), sa1 at its own, much higher one. When both passes are
    spatial on the same ``ops_impl``, one Morton sort
    (``ops.spatial_sorted_view``) feeds both as contiguous chains over the
    sorted view, bitwise two ``segment_mode="spatial"`` calls, and the view
    is returned for the box-pruned mask projection."""
    g, rp = cfg.gspn, cfg.rpointnet
    seed_segs = ops.eligible_fps_segments(g.fps_segments, cfg.num_seeds, n)
    sa1_segs = ops.eligible_fps_segments(cfg.sa1_fps_segments, sa1_n, n)
    if (g.ops_impl == rp.ops_impl and g.fps_segment_mode == rp.fps_segment_mode == "spatial"
            and seed_segs > 1 and sa1_segs > 1):
        view = ops.spatial_sorted_view(xyz, valid)
        sxyz, svalid, sidx = view
        seed_pos = ops.farthest_point_sample(cfg.num_seeds, sxyz, svalid, impl=g.ops_impl,
                                             segments=seed_segs, segment_mode="contiguous")
        sa1_pos = ops.farthest_point_sample(sa1_n, sxyz, svalid, impl=rp.ops_impl,
                                            segments=sa1_segs, segment_mode="contiguous")
        return (torch.gather(sidx, 1, seed_pos.long()), torch.gather(sidx, 1, sa1_pos.long()),
                view)
    seed_idx = ops.farthest_point_sample(cfg.num_seeds, xyz, valid, impl=g.ops_impl,
                                         segments=seed_segs, segment_mode=g.fps_segment_mode)
    sa1_idx = ops.farthest_point_sample(sa1_n, xyz, valid, impl=rp.ops_impl,
                                        segments=sa1_segs, segment_mode=rp.fps_segment_mode)
    return seed_idx, sa1_idx, None


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

    The model must have been built from this config's stages (its modules
    keep their ``ops_impl``), or ``infer`` raises ``ValueError``: the config
    a model was built with is the config it runs.

    Float32 matrix products are assumed to stay float32 (torch's default;
    a TF32 product can flip a mask threshold): callers that enable TF32 get
    different masks. ``serve.runtime.float32_matmuls`` pins it for a block,
    ``utils.bench_slice.pin_float32_matmuls`` for the process."""
    check_supported(cfg)

    def infer(model: PipelineModel, xyz, valid=None, z_eps=None, generator=None):
        if model.gspn.config != cfg.gspn or model.rpointnet.config != cfg.rpointnet:
            raise ValueError(
                "the model was built from other stage configs than this inference "
                "function's; build it from the same PipelineConfig"
            )
        seed_idx, sa1_idx, view = shared_fps_indices_view(cfg, xyz, valid)
        gout = model.gspn(xyz, seed_idx, valid, z_eps=z_eps, generator=generator)
        boxes = proposal_boxes(gout.generated, cfg.rpointnet.box_margin, cfg.box_percentile)
        obj = torch.sigmoid(gout.objectness)
        keep = ops.nms_3d_batched(
            boxes, obj, cfg.rpointnet.nms_iou, impl=cfg.rpointnet.ops_impl
        )

        out = model.rpointnet(xyz, boxes, valid, sa1_fps_idx=sa1_idx)
        fg_prob = torch.softmax(out.cls_logits, dim=-1)[..., 1:]  # drop background
        cls = (fg_prob.argmax(dim=-1) + 1).to(torch.int32)
        score = obj * fg_prob.amax(dim=-1)
        refined = apply_box_deltas(boxes, out.box_deltas)

        pvalid = keep & out.roi_valid & (score > cfg.score_thresh)
        masks = project_roi_masks(
            xyz, refined, out.roi_xyz, out.mask_logits, cfg.mask_thresh, valid,
            impl=cfg.rpointnet.ops_impl, mode=cfg.mask_project,
            sorted_view=view if cfg.mask_project_prune == "auto" else None,
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


def make_streamed_inference_fn(cfg: PipelineConfig):
    """Returns ``run(model, xyz_s (T,B,N,3), valid_s (T,B,N), z_eps_s
    (T,B,num_seeds,latent_dim)) -> InstancePredictions`` with a leading T
    on every field: exactly T separate :func:`make_inference_fn` calls,
    batch t with noise ``z_eps_s[t]`` (drawn outside, so no random draw
    runs inside a graph; the JAX package takes a key a batch).

    On CUDA tensors one request is captured in a CUDA graph
    (``utils.cuda_graph.GraphedRequest``: a warm-up call, then the
    capture) and replayed T times, the counterpart of the JAX package's
    one-dispatch ``lax.scan``; on CPU tensors the calls run in a loop.
    ``run`` keeps each capture for its model and batch shapes, so a later
    call of those shapes only copies in and replays. A replay reads the
    model's parameters and buffers where the capture found them: copy new
    weights into them (``load_state_dict``) rather than replacing them."""
    infer = make_inference_fn(cfg)
    graphs = weakref.WeakKeyDictionary()  # model -> {batch shapes: GraphedRequest}

    def request(model, xyz, valid, z_eps):
        p = infer(model, xyz, valid, z_eps=z_eps)
        return tuple(getattr(p, f) for f in PREDICTION_FIELDS)

    def run(model, xyz_s, valid_s, z_eps_s):
        batches = list(zip(xyz_s, valid_s, z_eps_s, strict=True))
        if xyz_s.is_cuda:
            key = tuple((x.shape, x.dtype, x.device) for x in batches[0])
            captured = graphs.setdefault(model, {})
            if key not in captured:
                captured[key] = GraphedRequest(functools.partial(request, model), *batches[0])
            outs = [captured[key](*batch) for batch in batches]
        else:
            outs = [request(model, *batch) for batch in batches]
        return InstancePredictions(*(torch.stack(field) for field in zip(*outs)))

    return run


def init_pipeline_variables(cfg: PipelineConfig, generator: torch.Generator, n: int):
    """Seeded weights for both stages as a :class:`PipelineModel` state dict,
    initialized as the JAX package initializes them
    (``nn.layers.glorot_init_``: glorot-uniform Linear weights, zero biases,
    BatchNorm scale 1 / bias 0 / mean 0 / var 1).

    ``n`` (points per scene) is kept for signature parity with the JAX
    function, which traces dummy inputs of that size; no width here depends
    on it. The draws come from ``generator`` in module order, so they are
    reproducible but are not the JAX package's numbers."""
    del n
    model = PipelineModel(cfg)
    glorot_init_(model, generator)
    return model.state_dict()
