"""Helpers for holding the PyTorch port (``gspn_tpu_torch``) against the JAX
package on the same NumPy inputs and weights."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gspn_tpu_torch.models import gspn as tg
from gspn_tpu_torch.models import pipeline as tp
from gspn_tpu_torch.models import rpointnet as tr


def t(x, dtype=None):
    """NumPy/JAX array -> CPU torch tensor (bool stays bool)."""
    return torch.from_numpy(np.array(x, dtype=dtype))


def n(x):
    """torch tensor -> NumPy array."""
    return x.detach().cpu().numpy()


def _stage(jcfg, tcls, **override):
    kw = {}
    for f in dataclasses.fields(tcls):
        if f.name in override:
            kw[f.name] = override[f.name]
        elif f.name == "ops_impl":
            kw[f.name] = "auto"
        elif f.name == "dtype":
            kw[f.name] = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[jcfg.dtype]
        elif f.name == "sa_layers":
            kw[f.name] = tuple(tr.SALayerSpec(*dataclasses.astuple(s)) for s in jcfg.sa_layers)
        else:
            kw[f.name] = getattr(jcfg, f.name)
    return tcls(**kw)


def gspn_config(jcfg) -> tg.GSPNConfig:
    return _stage(jcfg, tg.GSPNConfig)


def rpointnet_config(jcfg) -> tr.RPointNetConfig:
    return _stage(jcfg, tr.RPointNetConfig)


def pipeline_config(jcfg, **override) -> tp.PipelineConfig:
    """The port's counterpart of a JAX ``PipelineConfig`` (ops on "auto")."""
    kw = {
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(tp.PipelineConfig)
        if f.name not in ("gspn", "rpointnet")
    }
    kw.update(override)
    return tp.PipelineConfig(
        gspn=gspn_config(jcfg.gspn), rpointnet=rpointnet_config(jcfg.rpointnet), **kw
    )


def randomized(variables, seed: int, std: float = 0.3):
    """The same variable tree with every leaf redrawn (BatchNorm variances
    positive, the rest normal with ``std``), so BatchNorm and biases are
    exercised, not their init."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = np.shape(leaf)
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 2.0, shape), jnp.float32)
        if name == "scale":
            return jnp.asarray(rng.uniform(0.5, 1.5, shape), jnp.float32)
        return jnp.asarray(rng.normal(0.0, std, shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def as_numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)
