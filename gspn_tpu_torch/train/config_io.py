"""Config serialization: the port's own copy of ``save_config`` and
``config_from_jsonable`` from ``gspn_tpu/train/config_io.py``. Dataclass
config trees and argparse namespaces go to JSON beside the checkpoints, so
a run describes itself, and into a serving artifact's manifest, which
:func:`config_from_jsonable` reads back."""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

import torch


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


def config_from_jsonable(obj: Any, registry: dict[str, type], *, _field=None):
    """Inverse of :func:`_to_jsonable` for dataclass config trees.

    ``registry`` maps the ``__dataclass__`` tag (class ``__name__``) to the
    dataclass type. JSON lists become tuples (every sequence field of the
    configs is a tuple), and a field named ``dtype`` takes the string
    ``_to_jsonable`` wrote (``"torch.float32"``, or the JAX package's
    ``"float32"``) as the torch dtype of that name. An unknown tag or field
    raises ``ValueError``, so a manifest from a newer version fails loudly
    instead of half-loading."""
    if isinstance(obj, dict) and "__dataclass__" in obj:
        tag = obj["__dataclass__"]
        if tag not in registry:
            raise ValueError(f"unknown config dataclass {tag!r}; known: {sorted(registry)}")
        cls = registry[tag]
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in obj.items():
            if k == "__dataclass__":
                continue
            if k not in fields:
                raise ValueError(f"{tag} has no field {k!r}")
            kwargs[k] = config_from_jsonable(v, registry, _field=fields[k])
        return cls(**kwargs)
    if isinstance(obj, dict):
        return {k: config_from_jsonable(v, registry) for k, v in obj.items()}
    if isinstance(obj, list):
        return tuple(config_from_jsonable(x, registry) for x in obj)
    if _field is not None and _field.name == "dtype" and isinstance(obj, str):
        dtype = getattr(torch, obj.removeprefix("torch."), None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"unknown dtype {obj!r}")
        return dtype
    return obj


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
