"""Checkpoints with ``torch.save``: the PyTorch counterpart of
``gspn_tpu/train/checkpoint.py``. A checkpoint holds the update count, the
model's state dict (parameters and BatchNorm running statistics) and the
optimizer's. No random-generator state is kept: the trainer seeds every
step's generator from ``(seed, step)``, so a restored run draws what the
uninterrupted run drew."""

from __future__ import annotations

import os
import pathlib
import re

import torch

from gspn_tpu_torch.train.steps import TrainState

_NAME = re.compile(r"ckpt_(\d+)\.pt")


class CheckpointManager:
    """``ckpt_<step>.pt`` files under ``directory``, the newest
    ``max_to_keep`` kept."""

    def __init__(self, directory: str | pathlib.Path, max_to_keep: int = 3):
        self._dir = pathlib.Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self._dir.iterdir()
                      if (m := _NAME.fullmatch(p.name)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState) -> pathlib.Path:
        path = self._dir / f"ckpt_{state.step}.pt"
        tmp = path.with_suffix(".tmp")
        torch.save({"step": state.step, "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict()}, tmp)
        os.replace(tmp, path)  # a reader sees the whole file or none
        for old in self.steps()[:-self.max_to_keep]:
            (self._dir / f"ckpt_{old}.pt").unlink()
        return path

    def restore(self, state: TrainState, step: int | None = None) -> bool:
        """Load checkpoint ``step`` (default the latest) into ``state`` in
        place, onto the model's device. False when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return False
        device = next(state.model.parameters()).device
        payload = torch.load(self._dir / f"ckpt_{step}.pt", map_location=device,
                             weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return True

    def restore_params(self, variables, step: int | None = None) -> dict | None:
        """The parameters and BatchNorm running statistics of checkpoint
        ``step`` (default the latest), whatever optimizer wrote it: the
        entries of ``variables``' state dict (a model, or a state dict; only
        its keys are read), on the CPU. None when there is no checkpoint,
        ``KeyError`` naming the entries it lacks."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        keys = (variables.state_dict() if isinstance(variables, torch.nn.Module)
                else variables).keys()
        state = torch.load(self._dir / f"ckpt_{step}.pt", map_location="cpu",
                           weights_only=True)["model"]
        missing = [k for k in keys if k not in state]
        if missing:
            raise KeyError(f"the checkpoint under {self._dir} lacks {missing[:5]}")
        return {k: state[k] for k in keys}


def latest_model_state(directory: str | pathlib.Path, map_location="cpu") -> dict:
    """The model state dict of the newest checkpoint under ``directory``
    (parameters and running statistics only, whatever the optimizer), as
    stage 2 restores a stage-1 run's weights. ``FileNotFoundError`` when
    there is none."""
    path = pathlib.Path(directory)
    step = CheckpointManager(path).latest_step() if path.is_dir() else None
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    return torch.load(path / f"ckpt_{step}.pt", map_location=map_location,
                      weights_only=True)["model"]


def restore_variable_collections(ckpt_dir: str | pathlib.Path,
                                 variables) -> dict[str, torch.Tensor]:
    """The parameters and BatchNorm running statistics of the newest
    checkpoint under ``ckpt_dir``, whatever optimizer wrote it: the entries
    of ``variables``' state dict (a model, or a state dict; only its keys
    are read), on the CPU, as eval and a frozen stage restore weights.
    ``FileNotFoundError`` when there is no checkpoint, ``KeyError`` naming
    the entries it lacks."""
    if not pathlib.Path(ckpt_dir).is_dir():
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    restored = CheckpointManager(ckpt_dir).restore_params(variables)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return restored


def load_stage1_params(ckpt_dir: str | pathlib.Path, abstract,
                       subtree: str | None = None) -> dict[str, torch.Tensor]:
    """The parameters of the newest stage-1 (GSPN) checkpoint under
    ``ckpt_dir``, to start a stage-2 proposal net from: the entries of
    ``abstract``'s parameters (a model of the checkpoint's architecture, or
    a :class:`TrainState` holding one; only its parameter names are read),
    so neither the BatchNorm statistics nor the optimizer's state. With
    ``subtree``, those of that named submodule only, keyed relative to it
    (``KeyError`` if it holds none). ``FileNotFoundError`` when there is no
    checkpoint. The tensors are on the CPU."""
    model = abstract.model if isinstance(abstract, TrainState) else abstract
    state = latest_model_state(ckpt_dir)
    params = {name: state[name] for name, _ in model.named_parameters()}
    if subtree:
        prefix = subtree + "."
        params = {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}
        if not params:
            raise KeyError(subtree)
    return params
