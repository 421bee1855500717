"""The inference slice as ``chip_smoke.py`` and ``profile_slice`` drive it:
its config and the variants of it, the seeded model, the plain-path model
and the bench's two request shapes, set up in one place so both measure
the same program."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gspn_tpu_torch.data import synthetic
from gspn_tpu_torch.models.pipeline import (
    PipelineConfig,
    PipelineModel,
    init_pipeline_variables,
)
from gspn_tpu_torch.models.presets import scannet_pipeline, set_pipeline_group_select

# shape name -> (B, N, scene_batch kwargs, padded tail); bench.py's flagship
# request and its whole scene with the last ~10 % of points invalid
SHAPES = {
    "B8xN8192": (8, 8192, dict(max_instances=8), False),
    "B1xN65536": (1, 65536, dict(max_instances=24, extent=8.0), True),
}


def slice_config() -> PipelineConfig:
    """``scannet_pipeline()`` as the JAX package ships it (1-NN masks, FP
    interpolation "auto"), with only the two thresholds moved.

    Random weights put every score below the preset's 0.05 (fg probability
    ~1/18 x objectness ~0.5) and every mask logit just below 0, which would
    leave every mask empty and a comparison of outputs blind to the mask
    projection: keep all NMS survivors and threshold the masks where those
    logits fall (``mask_thresh=0.49`` is a logit of -0.04)."""
    return dataclasses.replace(scannet_pipeline(), score_thresh=0.0, mask_thresh=0.49)


VARIANTS = ("prune", "grid", "3nn", "strided")


def variant_config(name: str) -> PipelineConfig:
    """:func:`slice_config` with one knob of the JAX package set: "prune"
    (``mask_project_prune="auto"``), "grid" (``roi_sample="grid"``), "3nn"
    (``mask_project="3nn"``) or "strided" (``group_select="strided"`` in both
    stages). All take the same weights."""
    cfg = slice_config()
    if name == "prune":
        return dataclasses.replace(cfg, mask_project_prune="auto")
    if name == "grid":
        grid = dataclasses.replace(cfg.rpointnet, roi_sample="grid")
        return dataclasses.replace(cfg, rpointnet=grid)
    if name == "3nn":
        return dataclasses.replace(cfg, mask_project="3nn")
    if name == "strided":
        return set_pipeline_group_select(cfg, "strided")
    raise ValueError(f"variant must be {'|'.join(VARIANTS)}, got {name!r}")


def plain_config(cfg: PipelineConfig) -> PipelineConfig:
    """``cfg`` with both stages on the plain PyTorch ops."""
    return dataclasses.replace(
        cfg,
        gspn=dataclasses.replace(cfg.gspn, ops_impl="plain"),
        rpointnet=dataclasses.replace(cfg.rpointnet, ops_impl="plain"),
    )


def rebuilt_model(cfg: PipelineConfig, model: PipelineModel) -> PipelineModel:
    """A model built from ``cfg`` with ``model``'s weights, on its device, in
    eval mode (modules keep the ``ops_impl`` of the config they were built
    from, so each config needs its own model)."""
    out = PipelineModel(cfg)
    out.load_state_dict(model.state_dict())
    return out.to(next(model.parameters()).device).eval()


def plain_model(cfg: PipelineConfig, model: PipelineModel) -> tuple[PipelineConfig, PipelineModel]:
    """``(plain_config(cfg), model rebuilt from it with model's weights)``:
    the plain path, which launches no kernel."""
    pcfg = plain_config(cfg)
    return pcfg, rebuilt_model(pcfg, model)


def seeded_model(cfg: PipelineConfig, device) -> PipelineModel:
    """Eval-mode model with weights from ``torch.Generator().manual_seed(0)``."""
    model = PipelineModel(cfg)
    model.load_state_dict(init_pipeline_variables(cfg, torch.Generator().manual_seed(0), 8192))
    return model.to(device).eval()


def scenes(shape: str) -> tuple[np.ndarray, np.ndarray]:
    """``(xyz (B,N,3) f32, valid (B,N) bool)`` of one of :data:`SHAPES`,
    from ``scene_batch(default_rng(0), ...)`` as ``bench.py`` makes them."""
    b, n, kw, pad = SHAPES[shape]
    sb = synthetic.scene_batch(np.random.default_rng(0), b, n_points=n, **kw)
    valid = sb["valid"].copy()
    if pad:
        valid[:, -n // 10:] = False  # as bench.py pads it
    return sb["xyz"], valid


def request(cfg: PipelineConfig, shape: str, device, seed: int):
    """``(xyz, valid, z_eps)`` on ``device``: the scenes of ``shape`` and
    CVAE noise from ``torch.Generator().manual_seed(seed)``."""
    xyz, valid = scenes(shape)
    eps = torch.randn((xyz.shape[0], cfg.num_seeds, cfg.gspn.latent_dim),
                      generator=torch.Generator().manual_seed(seed))
    return torch.from_numpy(xyz).to(device), torch.from_numpy(valid).to(device), eps.to(device)


def float32_matmuls() -> None:
    """Turn TF32 off for matmuls and cuDNN, process-wide: a TF32 product can
    flip a mask threshold between the kernel path and its references."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
