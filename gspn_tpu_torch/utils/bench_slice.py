"""The slices as ``chip_smoke.py``, ``profile_slice`` and the card tests
drive them, set up in one place so all measure the same program: the
inference slice's config and its variants, the seeded model, the
plain-path model and the bench's two request shapes; the stage-1 training
slice's config, batch, seeded GSPN and plain-path GSPN; and the stage-2
training slice's configs, seeded frozen GSPN and R-PointNet and the
R-PointNet's plain twin."""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from gspn_tpu_torch.data import synthetic
from gspn_tpu_torch.models.gspn import GSPN, GSPNConfig
from gspn_tpu_torch.models.pipeline import (
    PipelineConfig,
    PipelineModel,
    init_pipeline_variables,
)
from gspn_tpu_torch.models.presets import scannet_pipeline, set_pipeline_group_select
from gspn_tpu_torch.models.rpointnet import RPointNet, RPointNetConfig
from gspn_tpu_torch.nn.layers import glorot_init_

# shape name -> (B, N, scene_batch kwargs, padded tail); bench.py's flagship
# request and its whole scene with the last ~10 % of points invalid
SHAPES = {
    "B8xN8192": (8, 8192, dict(max_instances=8), False),
    "B1xN65536": (1, 65536, dict(max_instances=24, extent=8.0), True),
}


def slice_config(**preset) -> PipelineConfig:
    """``scannet_pipeline(**preset)`` (by default as the JAX package ships
    it: 1-NN masks, FP interpolation "auto"), with only the two thresholds
    moved.

    Random weights put every score below the preset's 0.05 (fg probability
    ~1/18 x objectness ~0.5) and every mask logit just below 0, which would
    leave every mask empty and a comparison of outputs blind to the mask
    projection: keep all NMS survivors and threshold the masks where those
    logits fall (``mask_thresh=0.49`` is a logit of -0.04)."""
    return dataclasses.replace(scannet_pipeline(**preset), score_thresh=0.0, mask_thresh=0.49)


VARIANTS = ("prune", "grid", "3nn", "strided", "exact")


def variant_config(name: str) -> PipelineConfig:
    """:func:`slice_config` with one knob of the JAX package set: "prune"
    (``mask_project_prune="auto"``), "grid" (``roi_sample="grid"``), "3nn"
    (``mask_project="3nn"``), "strided" (``group_select="strided"`` in both
    stages) or "exact" (``scannet_pipeline(fps_segments=1)``: the exact
    greedy FPS, the JAX package's reference sampling). All take the same
    weights."""
    if name == "exact":
        return slice_config(fps_segments=1)
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


def pin_float32_matmuls() -> None:
    """Turn TF32 off for matmuls and cuDNN, process-wide, for scripts that
    time and compare (``serve.runtime.float32_matmuls`` is the same for a
    block): a TF32 product can flip a mask threshold between the kernel path
    and its references."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# the training slice: ``train_gspn``'s defaults (B=4 x N=4096 synthetic
# scenes, 64 FPS seeds, 256 GT points per seed)
TRAIN_BATCH, TRAIN_POINTS, TRAIN_SEEDS, TRAIN_GT = 4, 4096, 64, 256


def train_config() -> GSPNConfig:
    """``GSPNConfig()`` at full width, as ``train_gspn`` trains it."""
    return GSPNConfig()


def train_batch(device, b: int = TRAIN_BATCH, n: int = TRAIN_POINTS) -> dict:
    """``scene_batch(default_rng(0), b, n_points=n, max_instances=8)`` as
    tensors on ``device`` (``xyz``, ``valid``, ``inst_label``, ...)."""
    sb = synthetic.scene_batch(np.random.default_rng(0), b, n_points=n, max_instances=8)
    return {k: torch.from_numpy(v).to(device) for k, v in sb.items()}


def seeded_gspn(cfg: GSPNConfig, device, recognition: bool = True) -> GSPN:
    """Training-mode GSPN with glorot weights from
    ``torch.Generator().manual_seed(0)``."""
    model = GSPN(cfg, recognition=recognition)
    glorot_init_(model, torch.Generator().manual_seed(0))
    return model.to(device).train()


def plain_gspn(cfg: GSPNConfig, model: GSPN) -> tuple[GSPNConfig, GSPN]:
    """``(cfg on the plain ops, a GSPN built from it with model's weights
    and mode, on its device)``: the training slice's plain path."""
    pcfg = dataclasses.replace(cfg, ops_impl="plain")
    out = GSPN(pcfg, recognition=model.has_recognition)
    out.load_state_dict(model.state_dict())
    return pcfg, out.to(next(model.parameters()).device).train(model.training)


# the stage-2 training slice: bench.py's value_train arm (the train batch
# above, 64 seeds from one shared exact FPS pass with SA1's 1024 centres, GT
# boxes of up to 16 instances, jittered and mixed in: 80 RoIs a scene)
STAGE2_INSTANCES = 16
# its kernel launches per step: fps for the shared pass and SA2-SA4;
# ball_group for the frozen GSPN's crops and SA1-SA4; box_group for the
# RoIAlign; three_nn and interp_mm at FP1-FP4; index_add for the backward
# of SA2-SA4's feature gathers, FP1-FP4's interpolation and the RoIAlign
STAGE2_PER_STEP = {"fps": 4, "ball_group": 5, "box_group": 1, "three_nn": 4, "interp_mm": 4,
                   "index_add": 8}


def stage2_configs() -> tuple[GSPNConfig, RPointNetConfig]:
    """``scannet_pipeline(fps_segments=1)``'s GSPN and R-PointNet configs at
    full width (exact FPS, as the trainers sample)."""
    cfg = scannet_pipeline(fps_segments=1)
    return cfg.gspn, cfg.rpointnet


def seeded_frozen_gspn(cfg: GSPNConfig, device) -> GSPN:
    """An inference GSPN in eval mode with glorot weights from
    ``torch.Generator().manual_seed(1)``: stage 2's frozen proposal net."""
    model = GSPN(cfg)
    glorot_init_(model, torch.Generator().manual_seed(1))
    return model.to(device).eval()


def seeded_rpointnet(cfg: RPointNetConfig, device) -> RPointNet:
    """Training-mode R-PointNet with glorot weights from
    ``torch.Generator().manual_seed(0)``."""
    model = RPointNet(cfg)
    glorot_init_(model, torch.Generator().manual_seed(0))
    return model.to(device).train()


def plain_rpointnet(cfg: RPointNetConfig, model: RPointNet) -> tuple[RPointNetConfig, RPointNet]:
    """``(cfg on the plain ops, an R-PointNet built from it with model's
    weights and mode, on its device)``: stage 2's plain path."""
    pcfg = dataclasses.replace(cfg, ops_impl="plain")
    out = RPointNet(pcfg)
    out.load_state_dict(model.state_dict())
    return pcfg, out.to(next(model.parameters()).device).train(model.training)


_BN_FED_BIAS = re.compile(r"\.dense_\d+\.bias$")


def assert_grads_close(got: dict, want: dict) -> None:
    """Hold one run's gradients (``name -> tensor``) of a training step
    against another run's whose sums may be taken in another order (the
    CPU's against the card's), which moves the small elements of a large
    gradient far in relative terms, so each parameter is held norm-wise: ``|got - want| <= 1e-4 |want| + 1e-6``. A
    Dense bias that feeds a training-mode BatchNorm (``*.dense_<i>.bias``)
    has a true gradient of 0 (the batch mean removes it): both runs' values
    are rounding noise, held within an atol of 1e-5 x the largest gradient
    of the same layer's weight."""
    for name, w in want.items():
        g = got[name]
        if _BN_FED_BIAS.search(name):
            atol = 1e-5 * want[name[: -len("bias")] + "weight"].abs().max().item()
            torch.testing.assert_close(g, w, rtol=0.0, atol=atol,
                                       msg=lambda m, name=name: f"gradient {name}: {m}")
            continue
        err, ref = (g - w).norm().item(), w.norm().item()
        if not err <= 1e-4 * ref + 1e-6:
            raise AssertionError(f"gradient {name}: |got - want| = {err:.3e} against "
                                 f"|want| = {ref:.3e}")
