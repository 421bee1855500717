"""Structured metrics logging: the port's own copy of
``gspn_tpu/train/metrics.py`` (JSONL records, one line per logged step)."""

from __future__ import annotations

import json
import pathlib
import time


class MetricsLogger:
    def __init__(self, log_dir: str | pathlib.Path, name: str = "train"):
        d = pathlib.Path(log_dir)
        d.mkdir(parents=True, exist_ok=True)
        self._path = d / f"{name}.jsonl"
        self._fh = self._path.open("a")
        self._t0 = time.time()

    def log(self, step: int, metrics: dict, **extra):
        rec = {
            "step": int(step),
            "time": round(time.time() - self._t0, 3),
            **{k: float(v) for k, v in metrics.items()},
            **extra,
        }
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        return rec

    def close(self):
        self._fh.close()


def format_metrics(step: int, metrics: dict) -> str:
    parts = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
    return f"step {step}: {parts}"
