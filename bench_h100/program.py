"""The system under test, the PyTorch and CUDA package, as the benchmark
drives it: its configs built from a configuration file, the serving
session (``InferenceSession`` over an artifact of ``export_inference``)
and the training steps of ``train/steps.py``. Only this module of the
benchmark imports the program."""

from __future__ import annotations

import dataclasses
import pathlib

import torch

from gspn_tpu_torch.models.gspn import GSPN, GSPNConfig
from gspn_tpu_torch.models.pipeline import PipelineConfig, PipelineModel
from gspn_tpu_torch.models.rpointnet import RPointNet, RPointNetConfig, SALayerSpec
from gspn_tpu_torch.serve.export import export_inference, save_artifact
from gspn_tpu_torch.serve.runtime import InferenceSession
from gspn_tpu_torch.train.steps import (
    TrainState,
    make_gspn_train_step,
    make_optimizer,
    make_rpointnet_loss_fn,
    make_train_step,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dataclass(cls, fields: dict):
    """``cls`` from a configuration file's fields: lists become tuples, a
    ``dtype`` names a torch dtype, ``sa_layers`` rows become
    ``SALayerSpec``; a field the class lacks raises."""
    names = {f.name for f in dataclasses.fields(cls)}
    extra = set(fields) - names
    if extra:
        raise ValueError(f"{cls.__name__} has no field {sorted(extra)}")
    kw = {}
    for k, v in fields.items():
        if k == "dtype":
            v = _DTYPES[v]
        elif k == "sa_layers":
            v = tuple(SALayerSpec(int(n), float(r), int(s), tuple(m)) for n, r, s, m in v)
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kw[k] = v
    return cls(**kw)


def gspn_config(cfg: dict) -> GSPNConfig:
    return _dataclass(GSPNConfig, cfg["gspn"])


def rpointnet_config(cfg: dict) -> RPointNetConfig:
    return _dataclass(RPointNetConfig, cfg["rpointnet"])


PIPELINE_KEYS = ("num_seeds", "score_thresh", "mask_thresh", "box_percentile", "mask_project",
                 "sa1_fps_segments", "mask_project_prune")


def pipeline_config(cfg: dict) -> PipelineConfig:
    return PipelineConfig(gspn=gspn_config(cfg), rpointnet=rpointnet_config(cfg),
                          **{k: cfg[k] for k in PIPELINE_KEYS})


def state_keys(cfg: dict) -> list[str]:
    """The program's state-dict keys for the configuration's model, in its
    order (on the meta device: nothing is allocated)."""
    with torch.device("meta"):
        if cfg["kind"] == "pipeline":
            return list(PipelineModel(pipeline_config(cfg)).state_dict())
        if cfg["kind"] == "gspn_train":
            return list(GSPN(gspn_config(cfg), recognition=True).state_dict())
        return list(RPointNet(rpointnet_config(cfg)).state_dict())


def session(cfg: dict, state: dict, batch: int, points: int, device, workdir) -> InferenceSession:
    """Export the pipeline at ``(batch, points)`` for ``device``'s platform,
    write the artifact under ``workdir`` and open a session on it with
    ``state``: what a serving host does before its first request (on the
    card the session captures its CUDA graph)."""
    pcfg = pipeline_config(cfg)
    model = PipelineModel(pcfg).eval()
    program = export_inference(pcfg, model, points, batch_size=batch, device=device)
    path = save_artifact(pathlib.Path(workdir) / "pipeline.gspnt", program, pcfg)
    return InferenceSession(path, state, device=device)


def train_step(cfg: dict, state: dict, frozen: dict | None, device):
    """``(step(batch, generator) -> metrics, TrainState)``: the stage's model
    in training mode with ``state``, Adam, and the step the trainer runs
    (``make_gspn_train_step`` for stage 1; ``make_train_step`` over
    ``make_rpointnet_loss_fn`` with the frozen GSPN for stage 2)."""
    t = cfg["train"]
    if cfg["kind"] == "gspn_train":
        model = GSPN(gspn_config(cfg), recognition=True)
        fn = make_gspn_train_step(t["num_seeds"], t["gt_size"])
    else:
        model = RPointNet(rpointnet_config(cfg))
        gmodel = GSPN(gspn_config(cfg))
        gmodel.load_state_dict(frozen)
        gmodel = gmodel.to(device).eval()
        fn = make_train_step(make_rpointnet_loss_fn(
            t["max_instances"], (gmodel, t["num_seeds"]), gt_box_jitter=t["gt_box_jitter"]))
    model.load_state_dict(state)
    model = model.to(device).train()
    ts = TrainState(model, make_optimizer(model, t["lr"]))

    def step(batch: dict, generator: torch.Generator) -> dict:
        return fn(ts, batch, generator=generator)

    return step, ts


def first_gradient(ts: TrainState, beta1: float = 0.9) -> dict:
    """Each parameter's first gradient as Adam received it, read back from
    its state after one step (``exp_avg = (1 - beta1) * g``)."""
    return {name: ts.optimizer.state[p]["exp_avg"].detach() / (1.0 - beta1)
            for name, p in ts.model.named_parameters() if p in ts.optimizer.state}
