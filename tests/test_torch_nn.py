"""The port's PointNet++ blocks (``gspn_tpu_torch.nn``) against the JAX
package's (``gspn_tpu.nn``), with every Flax variable redrawn at random and
carried across by ``gspn_tpu_torch.convert``. Matrix products sum in
another order in the two frameworks, hence ``rtol=1e-4, atol=1e-5``;
sampled indices and validity must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gspn_tpu.nn import layers as jl
from gspn_tpu.nn import pointnet2 as jp
from gspn_tpu_torch.convert import flax_to_state_dict
from gspn_tpu_torch.nn import layers as tl
from gspn_tpu_torch.nn import pointnet2 as tpn
from tests.torch_parity import as_numpy_tree, n, randomized, t

TOL = dict(rtol=1e-4, atol=1e-5)


def _port(module, variables):
    module.load_state_dict(flax_to_state_dict(as_numpy_tree(variables)))
    return module.eval()


def _cloud(rng, b, npts, pad=0.25):
    xyz = rng.uniform(0, 2, (b, npts, 3)).astype(np.float32)
    valid = np.ones((b, npts), bool)
    valid[:, npts - int(npts * pad):] = False
    return xyz, valid


@pytest.mark.parametrize("use_bn", [False, True])
def test_point_mlp(rng, use_bn):
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    jm = jl.PointMLP((8, 4), use_bn=use_bn)
    v = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    got = n(_port(tl.PointMLP(6, (8, 4), use_bn=use_bn), v)(t(x)))
    np.testing.assert_allclose(got, want, **TOL)


def test_fc_layers(rng):
    x = rng.normal(size=(3, 4, 6)).astype(np.float32)
    jm = jl.FCLayers((8, 5), 3)
    v = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(n(_port(tl.FCLayers(6, (8, 5), 3), v)(t(x))), want, **TOL)


def test_masked_batchnorm_eval(rng):
    x = rng.normal(size=(10, 6)).astype(np.float32)
    jm = jl.MaskedBatchNorm()
    v = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(n(_port(tl.MaskedBatchNorm(6), v)(t(x))), want, **TOL)


def test_masked_max(rng):
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    mask = rng.uniform(size=(3, 5)) > 0.5
    mask[0] = False  # an empty row pools to 0
    want = np.asarray(jl.masked_max(jnp.asarray(x), jnp.asarray(mask), axis=1))
    np.testing.assert_array_equal(n(tl.masked_max(t(x), t(mask), dim=1)), want)


@pytest.mark.parametrize("with_points", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_sa_module(rng, masked, with_points):
    xyz, valid = _cloud(rng, 2, 128)
    pts = rng.normal(size=(2, 128, 5)).astype(np.float32) if with_points else None
    vm = valid if masked else None
    jm = jp.PointNetSAModule(npoint=32, radius=0.4, nsample=8, mlp=(8, 16), ops_impl="xla")
    args = (jnp.asarray(xyz), None if pts is None else jnp.asarray(pts), vm)
    v = randomized(jm.init(jax.random.PRNGKey(0), *args), 4)
    jx, jf, jv = jm.apply(v, *args)
    tm = _port(tpn.PointNetSAModule(3 + (5 if with_points else 0), 32, 0.4, 8, (8, 16)), v)
    tx, tf, tv = tm(t(xyz), None if pts is None else t(pts), t(valid) if masked else None)
    np.testing.assert_array_equal(n(tx), np.asarray(jx))
    np.testing.assert_allclose(n(tf), np.asarray(jf), **TOL)
    if masked:
        np.testing.assert_array_equal(n(tv), np.asarray(jv))
    else:
        assert tv is None and jv is None


@pytest.mark.parametrize("masked", [False, True])
def test_sa_module_strided(rng, masked):
    """``select="strided"`` neighborhoods, as the JAX SA module takes them."""
    xyz, valid = _cloud(rng, 2, 400)
    vm = valid if masked else None
    jm = jp.PointNetSAModule(npoint=32, radius=0.4, nsample=8, mlp=(8, 16), ops_impl="xla",
                             select="strided")
    v = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(xyz), None, vm), 6)
    jx, jf, _ = jm.apply(v, jnp.asarray(xyz), None, vm)
    tm = _port(tpn.PointNetSAModule(3, 32, 0.4, 8, (8, 16), select="strided"), v)
    tx, tf, _ = tm(t(xyz), None, t(valid) if masked else None)
    np.testing.assert_array_equal(n(tx), np.asarray(jx))
    np.testing.assert_allclose(n(tf), np.asarray(jf), **TOL)
    first = _port(tpn.PointNetSAModule(3, 32, 0.4, 8, (8, 16)), v)
    assert not np.allclose(n(first(t(xyz), None, t(valid) if masked else None)[1]), n(tf),
                           **TOL)


def test_sa_module_with_precomputed_fps(rng):
    xyz, valid = _cloud(rng, 2, 64)
    fps_idx = rng.integers(0, 48, (2, 16)).astype(np.int32)
    jm = jp.PointNetSAModule(npoint=16, radius=0.5, nsample=8, mlp=(8,), ops_impl="xla")
    v = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(xyz), None, valid), 5)
    jx, jf, _ = jm.apply(v, jnp.asarray(xyz), None, valid, False, jnp.asarray(fps_idx))
    tx, tf, _ = _port(tpn.PointNetSAModule(3, 16, 0.5, 8, (8,)), v)(
        t(xyz), None, t(valid), fps_idx=t(fps_idx))
    np.testing.assert_array_equal(n(tx), np.asarray(jx))
    np.testing.assert_allclose(n(tf), np.asarray(jf), **TOL)


@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_fp_module_exact(rng, masked, with_skip):
    xyz1, valid1 = _cloud(rng, 2, 96)
    xyz2, valid2 = _cloud(rng, 2, 24, pad=0.3)
    p1 = rng.normal(size=(2, 96, 4)).astype(np.float32) if with_skip else None
    p2 = rng.normal(size=(2, 24, 6)).astype(np.float32)
    v1, v2 = (valid1, valid2) if masked else (None, None)
    jm = jp.PointNetFPModule((16, 8), ops_impl="xla", interp="exact")
    args = (jnp.asarray(xyz1), jnp.asarray(xyz2), None if p1 is None else jnp.asarray(p1),
            jnp.asarray(p2), v1, v2)
    v = randomized(jm.init(jax.random.PRNGKey(0), *args), 6)
    want = np.asarray(jm.apply(v, *args))
    tm = _port(tpn.PointNetFPModule(6 + (4 if with_skip else 0), (16, 8)), v)
    got = tm(t(xyz1), t(xyz2), None if p1 is None else t(p1), t(p2),
             None if v1 is None else t(v1), None if v2 is None else t(v2))
    np.testing.assert_allclose(n(got), want, **TOL)


@pytest.mark.parametrize("interp", ["mm", "auto"])
@pytest.mark.parametrize("masked", [False, True])
def test_fp_module_interp(rng, masked, interp):
    """``interp="mm"`` against the JAX module's "mm" (the TPU kernel in
    interpret mode); "auto" on a CPU tensor is the exact interpolation, as
    the JAX "auto" is off the Pallas path."""
    xyz1, valid1 = _cloud(rng, 2, 96)
    xyz2, valid2 = _cloud(rng, 2, 24, pad=0.3)
    p1 = rng.normal(size=(2, 96, 4)).astype(np.float32)
    p2 = rng.normal(size=(2, 24, 6)).astype(np.float32)
    v1, v2 = (valid1, valid2) if masked else (None, None)
    jm = jp.PointNetFPModule((16, 8), ops_impl="xla", interp="mm" if interp == "mm" else "exact")
    args = (jnp.asarray(xyz1), jnp.asarray(xyz2), jnp.asarray(p1), jnp.asarray(p2), v1, v2)
    v = randomized(jm.init(jax.random.PRNGKey(0), *args), 7)
    want = np.asarray(jm.apply(v, *args))
    tm = _port(tpn.PointNetFPModule(10, (16, 8), interp=interp), v)
    targs = (t(xyz1), t(xyz2), t(p1), t(p2), None if v1 is None else t(v1),
             None if v2 is None else t(v2))
    got = n(tm(*targs))
    np.testing.assert_allclose(got, want, **TOL)
    if interp == "auto":
        tm.interp = "exact"
        np.testing.assert_array_equal(got, n(tm(*targs)))
    with pytest.raises(ValueError, match="interp"):
        tpn.PointNetFPModule(10, (16, 8), interp="fast")


@pytest.mark.parametrize("with_skip", [False, True])
def test_fp_module_mm_equals_exact(rng, with_skip):
    """``interp="mm"`` (``three_interpolate_fp``: weights, interpolation and
    skip concat in one call) gives the exact path's output and feature
    gradients bit for bit on the CPU."""
    xyz1, valid1 = _cloud(rng, 2, 96)
    xyz2, valid2 = _cloud(rng, 2, 24, pad=0.3)
    p1 = rng.normal(size=(2, 96, 4)).astype(np.float32) if with_skip else None
    p2 = rng.normal(size=(2, 24, 6)).astype(np.float32)
    tm = tpn.PointNetFPModule(6 + (4 if with_skip else 0), (16, 8), interp="exact")
    runs = []
    for interp in ("mm", "exact"):
        tm.interp = interp
        f1 = None if p1 is None else t(p1).requires_grad_(True)
        f2 = t(p2).requires_grad_(True)
        out = tm(t(xyz1), t(xyz2), f1, f2, t(valid1), t(valid2))
        out.square().sum().backward()
        runs.append((out, f2.grad, None if f1 is None else f1.grad))
    for got, want in zip(*runs, strict=True):
        assert (got is None) == (want is None)
        if got is not None:
            assert torch.equal(got, want)


def test_convert_rejects_unknown_leaves():
    with pytest.raises(ValueError, match="unknown Flax leaf"):
        flax_to_state_dict({"params": {"dense_0": {"gamma": np.zeros(3)}}})
    with pytest.raises(ValueError, match="unknown Flax collection"):
        flax_to_state_dict({"cache": {}})
    sd = flax_to_state_dict({"params": {"dense_0": {"kernel": np.ones((3, 5))}}})
    assert tuple(sd["dense_0.weight"].shape) == (5, 3)
    assert sd["dense_0.weight"].dtype == torch.float32
