"""Export the fused inference pipeline to a serving artifact.

The port's counterpart of ``gspn_tpu/serve/export.py``.
:func:`export_inference` traces ``make_inference_fn(cfg)`` once with
``torch.export`` at a fixed serving shape; :func:`save_artifact` and
:func:`load_artifact` wrap the program in one zip file with a JSON
manifest (format and version, platform, shapes, the pipeline config), so
an artifact describes itself.

The program's inputs are ``(state, xyz, valid, z_eps)``, or ``(state, xyz,
features, valid, z_eps)`` for a pipeline with per-point features (the JAX
package's order): ``state`` the model's state dict (the weights stay an
input, as the JAX package's variables do, so one artifact serves every
checkpoint of its architecture and holds no weights), ``z_eps`` the CVAE
noise, drawn outside the program.
It returns ``(masks, scores, classes, boxes, valid)``. Every kernel call is
one opaque ``gspn::`` op (``ops.common.gspn_op``), which runs its CUDA
kernel on the card and its plain version on the CPU.

A program traced on one device runs on that device only: the trace fixed
its tensors' device and took device-dependent choices (the FP
interpolation's form). So an artifact names its platform, ``cuda`` or
``cpu``, and :func:`load_artifact` refuses any other.

Serving host::

    program, manifest = load_artifact("model.gspnt", "cuda")
    masks, scores, classes, boxes, valid = program.module()(state, xyz, valid, z_eps)

or the whole runtime, ``serve.runtime.session_from_checkpoints``.
"""

from __future__ import annotations

import io
import json
import pathlib
import zipfile

import torch
from torch import nn

from gspn_tpu_torch.models.pipeline import (
    PREDICTION_FIELDS,
    PipelineConfig,
    PipelineModel,
    make_inference_fn,
)
from gspn_tpu_torch.train.config_io import _to_jsonable

FORMAT = "gspn_tpu_torch.serving"
FORMAT_VERSION = 1
PLATFORMS = ("cuda", "cpu")
_MANIFEST, _PROGRAM = "manifest.json", "program.pt2"


class _Infer(nn.Module):
    """``make_inference_fn(cfg)`` as a module: the pipeline's two stages
    under a ``PipelineModel``'s names, so its state dict keys are the
    model's."""

    def __init__(self, cfg: PipelineConfig, model: PipelineModel):
        super().__init__()
        self.gspn, self.rpointnet = model.gspn, model.rpointnet
        self._infer = make_inference_fn(cfg)

    def forward(self, xyz, valid, z_eps, features=None):
        preds = self._infer(self, xyz, valid, z_eps=z_eps, features=features)
        return tuple(getattr(preds, f) for f in PREDICTION_FIELDS)


class _Serving(nn.Module):
    """``forward(state, xyz, valid, z_eps)``: :class:`_Infer` with the
    weights taken from ``state`` (``torch.func.functional_call``). The
    pipeline is kept off the module's own attributes, so the exported
    program holds no parameters."""

    def __init__(self, infer: _Infer):
        super().__init__()
        self.__dict__["_pipeline"] = infer

    def forward(self, state: dict[str, torch.Tensor], xyz, valid, z_eps):
        return torch.func.functional_call(self._pipeline, state, (xyz, valid, z_eps))


class _ServingFeatures(_Serving):
    """``forward(state, xyz, features, valid, z_eps)``: :class:`_Serving`
    with the per-point input features."""

    def forward(self, state: dict[str, torch.Tensor], xyz, features, valid, z_eps):
        return torch.func.functional_call(self._pipeline, state, (xyz, valid, z_eps),
                                          {"features": features})


def feature_dim(cfg: PipelineConfig) -> int:
    """The per-point input features a pipeline reads (0: none)."""
    return max(cfg.gspn.feature_dim, cfg.rpointnet.feature_dim)


def serving_state(model: PipelineModel, device=None) -> dict[str, torch.Tensor]:
    """The program's ``state`` input: ``model``'s state dict, in its key
    order (the exported calling convention keeps that order), on
    ``device`` (default the model's)."""
    return {k: v.to(device) if device is not None else v
            for k, v in model.state_dict().items()}


def _example_inputs(cfg: PipelineConfig, n_points: int, batch_size: int, device):
    """``(xyz, [features,] valid, z_eps)`` of the serving shape: zeros, all
    points valid. They fix the traced shapes only; no value is read."""
    xyz = torch.zeros((batch_size, n_points, 3), dtype=torch.float32, device=device)
    rest = (torch.ones((batch_size, n_points), dtype=torch.bool, device=device),
            torch.zeros((batch_size, cfg.num_seeds, cfg.gspn.latent_dim), dtype=torch.float32,
                        device=device))
    if feature_dim(cfg):
        return (xyz, torch.zeros((batch_size, n_points, feature_dim(cfg)), device=device), *rest)
    return (xyz, *rest)


def export_inference(cfg: PipelineConfig, model: PipelineModel, n_points: int, *,
                     batch_size: int = 1, device="cuda") -> torch.export.ExportedProgram:
    """Export ``infer(state, xyz, valid, z_eps)`` at the serving shape
    ``(batch_size, n_points)`` for ``device`` (``"cuda"`` or ``"cpu"``).
    ``model`` (built from ``cfg``, in eval mode) supplies the state's keys,
    shapes and dtypes; its values are not baked in. A pipeline with
    per-point features (``feature_dim > 0``) takes them as the input after
    ``xyz``."""
    device = torch.device(device)
    if device.type not in PLATFORMS:
        raise ValueError(f"export for one of {PLATFORMS}, got {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("exporting for cuda needs a CUDA device")
    model = model.to(device).eval()
    serving = (_ServingFeatures if feature_dim(cfg) else _Serving)(_Infer(cfg, model))
    args = (serving_state(model), *_example_inputs(cfg, n_points, batch_size, device))
    with torch.no_grad():
        program = torch.export.export(serving, args, strict=False)
    program.example_inputs = None  # they hold the weights, which an artifact does not
    return program


def _user_inputs(program: torch.export.ExportedProgram) -> list:
    """The fake tensors of the program's inputs, in order: the state's, then
    ``xyz``, ``valid``, ``z_eps``."""
    names = set(program.graph_signature.user_inputs)
    return [n.meta["val"] for n in program.graph.nodes if n.op == "placeholder" and n.name in names]


def save_artifact(path: str | pathlib.Path, program: torch.export.ExportedProgram,
                  cfg: PipelineConfig, *, extra_meta: dict | None = None) -> pathlib.Path:
    """Write a single-file artifact: ``zip(manifest.json, program.pt2)``.
    The manifest's ``inputs`` holds ``features`` (its shape) for a pipeline
    with per-point features, and ``pipeline_config`` the config (its
    ``dtype`` and ``feature_dim`` included)."""
    names = ("xyz", "features", "valid", "z_eps") if feature_dim(cfg) else (
        "xyz", "valid", "z_eps")
    inputs = dict(zip(names, _user_inputs(program)[-len(names):], strict=True))
    platform = inputs["xyz"].device.type
    outs = [n.meta["val"] for n in program.graph.output_node().args[0]]
    manifest = {
        "format": FORMAT,
        "format_version": FORMAT_VERSION,
        "platforms": [platform],
        "torch": torch.__version__,
        "inputs": {k: list(v.shape) for k, v in inputs.items()},
        "outputs": {f: [list(o.shape), str(o.dtype)]
                    for f, o in zip(PREDICTION_FIELDS, outs, strict=True)},
        "pipeline_config": _to_jsonable(cfg),
        **(extra_meta or {}),
    }
    buf = io.BytesIO()
    torch.export.save(program, buf)
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(p, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(_MANIFEST, json.dumps(manifest, indent=2))
        z.writestr(_PROGRAM, buf.getvalue())
    return p


def _read_manifest(path: str | pathlib.Path) -> dict:
    """The manifest of the artifact at ``path``; ``ValueError`` for a file
    that is not an artifact of this format or is of a newer version."""
    try:
        with zipfile.ZipFile(path) as z:
            manifest = json.loads(z.read(_MANIFEST))
    except (zipfile.BadZipFile, KeyError, json.JSONDecodeError) as e:
        raise ValueError(f"{path} is not a {FORMAT} artifact ({e})") from e
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} artifact (format={manifest.get('format')!r})")
    if manifest.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(f"artifact format_version {manifest['format_version']} is newer than "
                         f"supported {FORMAT_VERSION}")
    return manifest


def load_artifact(path: str | pathlib.Path,
                  device="cuda") -> tuple[torch.export.ExportedProgram, dict]:
    """Read an artifact back for ``device``: ``(the exported program,
    manifest)``. Refuses a file that is not an artifact, a newer format
    version, and an artifact exported for another platform than
    ``device``'s (a ``cuda`` artifact on the CPU, a ``cpu`` one on the
    card)."""
    device = torch.device(device)
    manifest = _read_manifest(path)
    if device.type not in manifest["platforms"]:
        raise ValueError(f"{path} was exported for {manifest['platforms']}; it does not run on "
                         f"{device.type} (export it again for {device.type})")
    with zipfile.ZipFile(path) as z:
        program = torch.export.load(io.BytesIO(z.read(_PROGRAM)))
    return program, manifest
