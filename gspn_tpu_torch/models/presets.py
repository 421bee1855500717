"""Configuration presets: the PyTorch counterpart of
``gspn_tpu/models/presets.py``."""

from __future__ import annotations

import dataclasses

import torch

from gspn_tpu_torch.models.gspn import GSPNConfig
from gspn_tpu_torch.models.pipeline import PipelineConfig
from gspn_tpu_torch.models.rpointnet import RPointNetConfig, SALayerSpec


def _scale(widths, mult):
    return tuple(int(x * mult) for x in widths)


def scale_gspn_widths(cfg: GSPNConfig, mult: int) -> GSPNConfig:
    """Every GSPN MLP and FC width, and the conditioning dim, times
    ``mult``; the latent dim and the context geometry stay. The trainers'
    ``--width-mult``: a stage-2 run, an export or an eval that restores the
    checkpoint must scale by the same multiplier."""
    return dataclasses.replace(
        cfg,
        encoder_mlp=_scale(cfg.encoder_mlp, mult),
        center_mlp=_scale(cfg.center_mlp, mult),
        center_fc=_scale(cfg.center_fc, mult),
        generator_fc=_scale(cfg.generator_fc, mult),
        objectness_fc=_scale(cfg.objectness_fc, mult),
        cond_dim=int(cfg.cond_dim * mult),
    )


def scale_rpointnet_widths(cfg: RPointNetConfig, mult: int) -> RPointNetConfig:
    """Every backbone and head MLP width times ``mult``; the sampling
    geometry (npoint, radius, nsample, roi_samples) stays."""
    return dataclasses.replace(
        cfg,
        sa_layers=tuple(SALayerSpec(s.npoint, s.radius, s.nsample, _scale(s.mlp, mult))
                        for s in cfg.sa_layers),
        fp_mlps=tuple(_scale(m, mult) for m in cfg.fp_mlps),
        roi_mlp=_scale(cfg.roi_mlp, mult),
        cls_fc=_scale(cfg.cls_fc, mult),
        box_fc=_scale(cfg.box_fc, mult),
        mask_mlp=_scale(cfg.mask_mlp, mult),
    )


def scale_pipeline_widths(cfg: PipelineConfig, mult: int) -> PipelineConfig:
    """Both stages' widths times ``mult`` (:func:`scale_gspn_widths`,
    :func:`scale_rpointnet_widths`)."""
    return dataclasses.replace(cfg, gspn=scale_gspn_widths(cfg.gspn, mult),
                               rpointnet=scale_rpointnet_widths(cfg.rpointnet, mult))


def set_pipeline_group_select(cfg: PipelineConfig, select: str) -> PipelineConfig:
    """Both stages' neighborhood K-selection: "first" (first K in input
    order) or "strided" (a systematic sample of every hit, for spatially
    sorted layouts where first-K collapses to one corner of the ball). It
    applies to the GSPN context crops, the backbone's SA neighborhoods and
    the in-box RoI sampling."""
    return dataclasses.replace(
        cfg,
        gspn=dataclasses.replace(cfg.gspn, group_select=select),
        rpointnet=dataclasses.replace(cfg.rpointnet, group_select=select),
    )


def set_pipeline_fps_segments(cfg: PipelineConfig, segments: int,
                              mode: str = "contiguous") -> PipelineConfig:
    """The segmented parallel-chain FPS in both stages (the seeds and every
    eligible backbone SA layer): ``segments`` chains, partitioned
    "contiguous", "strided" or "spatial" (Morton-sorted inside the op)."""
    return dataclasses.replace(
        cfg,
        gspn=dataclasses.replace(cfg.gspn, fps_segments=segments, fps_segment_mode=mode),
        rpointnet=dataclasses.replace(cfg.rpointnet, fps_segments=segments,
                                      fps_segment_mode=mode),
    )


def scannet_pipeline(
    num_seeds: int = 64,
    num_classes: int = 18,
    feature_dim: int = 0,
    dtype: torch.dtype = torch.float32,
    fps_segments: int = 8,
    fps_segment_mode: str = "spatial",
    sa1_fps_segments: int = 0,
    group_select: str = "first",
) -> PipelineConfig:
    """The flagship scene-level inference preset (spatial segmented FPS,
    S=8, 1-NN mask projection, FP interpolation "auto")."""
    return PipelineConfig(
        gspn=GSPNConfig(
            context_radii=(0.25, 0.5, 1.0),
            context_nsample=(32, 64, 128),
            encoder_mlp=(64, 128, 256),
            num_gen_points=256,
            feature_dim=feature_dim,
            dtype=dtype,
            fps_segments=fps_segments,
            fps_segment_mode=fps_segment_mode,
            group_select=group_select,
        ),
        rpointnet=RPointNetConfig(
            num_classes=num_classes,
            feature_dim=feature_dim,
            dtype=dtype,
            fps_segments=fps_segments,
            fps_segment_mode=fps_segment_mode,
            group_select=group_select,
        ),
        num_seeds=num_seeds,
        sa1_fps_segments=sa1_fps_segments,
    )
