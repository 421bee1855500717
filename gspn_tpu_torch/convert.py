"""Carry JAX (Flax) variables across to the port's state dicts.

The port names its submodules after the Flax scopes, so the conversion is
a mechanical rename: ``params/a/b/dense_0/kernel`` (in, out) becomes
``a.b.dense_0.weight`` (out, in); ``bias`` and BatchNorm ``scale`` keep
their names; ``batch_stats/.../bn_0/mean|var`` become the BatchNorm
buffers. Inputs are nested dicts of array-likes (NumPy, or anything
``numpy.asarray`` takes), never JAX objects this module must import.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

# GSPN scopes that only training builds (recognition network); inference
# variables carry them, the port's inference model has no such modules
GSPN_TRAINING_ONLY = ("recog_enc", "recognition")


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def flax_to_state_dict(variables: Mapping, prefix: str = "", skip: tuple[str, ...] = ()):
    """``{"params": ..., "batch_stats": ...}`` of one Flax module -> flat
    torch state dict with keys under ``prefix``. Top-level scopes named in
    ``skip`` are dropped; an unknown collection or leaf name raises."""
    out = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"unknown Flax collection {collection!r}")
        for path, leaf in _flatten(tree):
            if path[0] in skip:
                continue
            arr = np.asarray(leaf, dtype=np.float32)
            name = path[-1]
            if collection == "params" and name == "kernel":
                if arr.ndim != 2:
                    raise ValueError(f"{'/'.join(path)}: Dense kernel must be 2-D")
                name, arr = "weight", arr.T
            elif (collection, name) not in (
                ("params", "bias"), ("params", "scale"),
                ("batch_stats", "mean"), ("batch_stats", "var"),
            ):
                raise ValueError(f"unknown Flax leaf {collection}/{'/'.join(path)}")
            key = prefix + ".".join(path[:-1] + (name,))
            out[key] = torch.tensor(arr)  # a copy: the input may be read-only
    return out


def pipeline_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX pipeline's variables ``{"gspn": {"params", "batch_stats"},
    "rpointnet": {...}}`` -> a ``PipelineModel`` state dict."""
    sd = flax_to_state_dict(variables["gspn"], "gspn.", skip=GSPN_TRAINING_ONLY)
    sd.update(flax_to_state_dict(variables["rpointnet"], "rpointnet."))
    return sd
