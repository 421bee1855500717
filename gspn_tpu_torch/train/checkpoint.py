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
