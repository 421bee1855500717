"""Config serialization: the port's own copy of ``save_config`` from
``gspn_tpu/train/config_io.py``. Dataclass config trees and argparse
namespaces go to JSON beside the checkpoints, so a run describes itself."""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any


def _to_jsonable(obj: Any):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            "__dataclass__": type(obj).__name__,
            **{f.name: _to_jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)},
        }
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    try:
        json.dumps(obj)
        return obj
    except TypeError:
        return str(obj)  # e.g. torch.float32 -> "torch.float32"


def save_config(path: str | pathlib.Path, **configs):
    """Write ``{name: config}`` trees as JSON. Accepts dataclasses, dicts and
    argparse namespaces."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    payload = {}
    for name, cfg in configs.items():
        if hasattr(cfg, "__dict__") and not dataclasses.is_dataclass(cfg):
            cfg = vars(cfg)
        payload[name] = _to_jsonable(cfg)
    p.write_text(json.dumps(payload, indent=2, default=str))
    return p
