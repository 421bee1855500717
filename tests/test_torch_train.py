"""GSPN stage-1 training in the port (``gspn_tpu_torch``) against the JAX
package, on the CPU at the trainer's TINY widths (B=2, N=256), with seeded
NumPy inputs, Flax variables (near their init) carried across by
``gspn_tpu_torch.convert`` and the CVAE noise the JAX side draws.

Tolerances, and why:

- indices (argmins, seeds, GT pairing) and the data stream: equal;
- ``nn_distance``'s distances: bitwise against ``impl="xla"`` (the same
  three products summed in the same order);
- single forwards and losses: ``rtol=1e-5, atol=1e-5`` (BatchNorm's batch
  statistics and the matrix products sum in another order);
- gradients: ``bench_slice.assert_grads_close`` (norm-wise within 1e-4; the
  Dense biases that feed a BatchNorm have a true gradient of 0 and are
  rounding noise on both sides, held within an atol scaled by their layer);
- parameters after Adam steps: ``rtol=1e-4, atol=1e-5``, and the
  BatchNorm-fed biases within ``2 * lr`` per step, since Adam turns their
  rounding noise into steps of up to about ``lr`` in a sign the rounding
  picks (so do the running means of the BatchNorms they feed, from the
  second step on).
"""

import argparse
import dataclasses
import hashlib
import json
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gspn_tpu import ops as jops
from gspn_tpu.data import augment as jaugment
from gspn_tpu.data import instances as jinstances
from gspn_tpu.data import iterator as jiterator
from gspn_tpu.data import synthetic as jsynthetic
from gspn_tpu.models import gspn as jg
from gspn_tpu.nn import layers as jl
from gspn_tpu.ops import chamfer as jchamfer
from gspn_tpu.train import schedules as jschedules
from gspn_tpu.train import steps as jsteps
from gspn_tpu.train import train_gspn as jtrain
from gspn_tpu_torch import ops
from gspn_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gspn_tpu_torch.data import augment as taugment
from gspn_tpu_torch.data import instances as tinstances
from gspn_tpu_torch.data import iterator as titerator
from gspn_tpu_torch.data import synthetic as tsynthetic
from gspn_tpu_torch.models import gspn as tg
from gspn_tpu_torch.models import pipeline as tpl
from gspn_tpu_torch.nn import layers as tl
from gspn_tpu_torch.train import schedules as tschedules
from gspn_tpu_torch.train import steps as tsteps
from gspn_tpu_torch.train import train_gspn as ttrain
from gspn_tpu_torch.utils import bench_slice
from tests.torch_parity import as_numpy_tree, gspn_config, n, randomized, t

FWD = dict(rtol=1e-5, atol=1e-5)
S, G = 8, 16  # seeds and GT points per seed at the TINY size
JCFG = dataclasses.replace(jtrain.TINY_GSPN, ops_impl="xla")


def _batch(seed=0, b=2, npts=256):
    """``scene_batch`` as ``tests/test_gspn.py`` builds it: NumPy arrays."""
    return jsynthetic.scene_batch(np.random.default_rng(seed), b, n_points=npts,
                                  max_instances=3, extent=2.0)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jmodel_vars():
    """A JAX TINY GSPN's training variables (recognition network included;
    see ``_perturbed``) and the batch they were initialized on."""
    batch = _batch()
    jb = _jbatch(batch)
    model = jg.GSPN(JCFG)
    seed_idx = jops.farthest_point_sample(S, jb["xyz"], jb["valid"], impl="xla")
    gt_pts, gt_valid, _, _ = jinstances.gather_seed_instances(
        jb["xyz"], jb["inst_label"], seed_idx, G)
    key = jax.random.PRNGKey(0)
    v = jax.jit(lambda *a: model.init(key, *a, valid=jb["valid"], gt_points=gt_pts,
                                      gt_valid=gt_valid, z_rng=key, train=False))(
        jb["xyz"], seed_idx)
    return model, _perturbed(v, 11), batch


def _perturbed(variables, seed):
    """Flax's initial variables (glorot kernels, the scale a training run
    starts from) with every other leaf redrawn near its init, so biases,
    BatchNorm's affine and its running statistics are exercised."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = np.shape(leaf)
        if name == "kernel":
            return leaf
        if name in ("scale", "var"):
            return jnp.asarray(rng.uniform(0.8, 1.25, shape), jnp.float32)
        return jnp.asarray(rng.normal(0.0, 0.1, shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _port_model(v):
    m = tg.GSPN(gspn_config(JCFG), recognition=True)
    m.load_state_dict(flax_to_state_dict(as_numpy_tree(v)), strict=True)
    return m.train()


def _z_eps(rng, b=2):
    """The CVAE noise ``make_gspn_loss_fn`` draws from ``rng``."""
    _, z_rng = jax.random.split(rng)
    return t(jax.random.normal(z_rng, (b, S, JCFG.latent_dim), jnp.float32))


def test_tiny_presets_agree():
    assert ttrain.TINY_GSPN == gspn_config(jtrain.TINY_GSPN)


# ---------------------------------------------------------------------------
# ops/chamfer.py
# ---------------------------------------------------------------------------


def _nn_inputs(rng, b=2, n1=37, m=50):
    xyz1 = rng.uniform(0, 1, (b, n1, 3)).astype(np.float32)
    half = rng.uniform(0, 1, (b, m // 2, 3)).astype(np.float32)
    xyz2 = np.concatenate([half, half], axis=1)  # source j + m/2 repeats j: ties
    valid1 = rng.uniform(size=(b, n1)) > 0.3
    valid2 = rng.uniform(size=(b, m)) > 0.3
    valid2[1] = False  # a row whose sources are all padded: index 0
    return xyz1, xyz2, valid1, valid2


@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("masked", [False, True])
def test_nn_distance_matches_jax(rng, jimpl, masked):
    """Indices equal to JAX's (XLA and the Pallas kernel in interpret mode),
    distances bitwise the XLA path's, gradients of both point sets within
    1e-5 of ``jax.grad`` (the same analytic gradient, summed in another
    order where a source is nearest to several targets)."""
    xyz1, xyz2, valid1, valid2 = _nn_inputs(rng)
    v1, v2 = (valid1, valid2) if masked else (None, None)
    w1 = rng.uniform(size=xyz1.shape[:2]).astype(np.float32)
    w2 = rng.uniform(size=xyz2.shape[:2]).astype(np.float32)
    kw = dict(impl=jimpl, interpret=True) if jimpl == "pallas" else dict(impl=jimpl)

    def jloss(a, b):
        d1, _, d2, _ = jchamfer.nn_distance(
            a, b, None if v1 is None else jnp.asarray(v1),
            None if v2 is None else jnp.asarray(v2), **kw)
        return jnp.sum(d1 * w1) + jnp.sum(d2 * w2)

    want = jchamfer.nn_distance(jnp.asarray(xyz1), jnp.asarray(xyz2),
                                None if v1 is None else jnp.asarray(v1),
                                None if v2 is None else jnp.asarray(v2), **kw)
    ga, gb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xyz1), jnp.asarray(xyz2))

    a, b = t(xyz1).requires_grad_(), t(xyz2).requires_grad_()
    got = ops.nn_distance(a, b, None if v1 is None else t(v1), None if v2 is None else t(v2))
    for i in (1, 3):
        assert got[i].dtype == torch.int32
        np.testing.assert_array_equal(n(got[i]), np.asarray(want[i]))
    if masked:
        assert not got[1][1].any()
    if jimpl == "xla":
        for i in (0, 2):
            np.testing.assert_array_equal(n(got[i]), np.asarray(want[i]))
    ((got[0] * t(w1)).sum() + (got[2] * t(w2)).sum()).backward()
    np.testing.assert_allclose(n(a.grad), np.asarray(ga), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(b.grad), np.asarray(gb), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_loss_matches_jax(rng, masked):
    xyz1, xyz2, _, valid2 = _nn_inputs(rng)
    v2 = valid2 if masked else None
    want = jchamfer.chamfer_loss(jnp.asarray(xyz1), jnp.asarray(xyz2),
                                 None if v2 is None else jnp.asarray(v2), impl="xla")
    got = ops.chamfer_loss(t(xyz1), t(xyz2), None if v2 is None else t(v2))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("mask2", [False, True])
@pytest.mark.parametrize("mask1", [False, True])
def test_nn_argmin_pair_matches_two_argmins_and_jax(rng, mask1, mask2, jimpl):
    """``nn_argmin_pair``'s plain version is bitwise two ``nn_argmin`` calls,
    and equal to JAX's argmin (``_argmin_xla``, and ``_argmin_pallas``, the
    TPU kernel in interpret mode) in both directions: N != M, duplicated
    sources and targets (ties to the lower index), each mask None or
    masked, with a row whose candidates are all invalid each way."""
    xyz1, xyz2, valid1, valid2 = _nn_inputs(rng)
    xyz1[:, 20:30] = xyz1[:, :10]  # targets 20-29 repeat 0-9: column ties
    valid1[0] = False  # scene 0: every target invalid for the column direction
    v1, v2 = (valid1 if mask1 else None), (valid2 if mask2 else None)
    tv1, tv2 = (None if v is None else t(v) for v in (v1, v2))
    got = ops.nn_argmin_pair(t(xyz1), t(xyz2), tv1, tv2)
    want = (ops.nn_argmin(t(xyz1), t(xyz2), tv2), ops.nn_argmin(t(xyz2), t(xyz1), tv1))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32 and g.shape == w.shape
        assert torch.equal(g, w)

    def jargmin(a, b, bv):
        a, b, bv = jnp.asarray(a), jnp.asarray(b), None if bv is None else jnp.asarray(bv)
        if jimpl == "pallas":
            return jchamfer._argmin_pallas(a, b, bv, True)
        return jchamfer._argmin_xla(a, b, bv)

    np.testing.assert_array_equal(n(got[0]), np.asarray(jargmin(xyz1, xyz2, v2)))
    np.testing.assert_array_equal(n(got[1]), np.asarray(jargmin(xyz2, xyz1, v1)))
    if mask2:
        assert not got[0][1].any()
    if mask1:
        assert not got[1][0].any()


def test_nn_argmin_plan():
    """One CTA a row up to 256 targets; a CTA a 256-target tile, at most
    16; passes beyond."""
    from gspn_tpu_torch.ops.chamfer import nn_argmin_plan

    assert nn_argmin_plan(1) == 1
    assert nn_argmin_plan(256) == 1  # slice (G)'s chamfer rows
    assert nn_argmin_plan(257) == 2
    assert nn_argmin_plan(600) == 3
    assert nn_argmin_plan(2048) == 8
    assert nn_argmin_plan(4096) == 16  # the tie case of 16 rows x 4096
    assert nn_argmin_plan(65536) == 16  # 16 passes


def test_nn_argmin_pair_cuda_refuses_a_cpu_tensor():
    a = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.nn_argmin_pair(a, a, impl="cuda")


def test_nn_argmin_pair_refuses_empty_point_sets():
    with pytest.raises(ValueError, match="at least one point"):
        ops.nn_argmin_pair(torch.zeros(1, 0, 3), torch.zeros(1, 4, 3))


def test_nn_argmin_cuda_refuses_a_cpu_tensor():
    a = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError):
        ops.nn_argmin(a, a, impl="cuda")


# ---------------------------------------------------------------------------
# nn/layers.py in training mode
# ---------------------------------------------------------------------------


def _bn_vars(rng, c):
    return {
        "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "bias": rng.normal(0, 0.3, c).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(0, 0.3, c).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, c).astype(np.float32)},
    }


@pytest.mark.parametrize("masked", [False, True])
def test_masked_batchnorm_training_matches_flax(rng, masked):
    """Output and running statistics after one training-mode call; the
    eval output afterwards uses the updated statistics."""
    x = rng.normal(0.5, 2.0, (3, 5, 7, 6)).astype(np.float32)
    mask = rng.uniform(size=(3, 5, 7)) > 0.4 if masked else None
    v = _bn_vars(rng, 6)
    y, mut = jl.MaskedBatchNorm().apply(
        jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x),
        mask=None if mask is None else jnp.asarray(mask), train=True, mutable=["batch_stats"])
    bn = tl.MaskedBatchNorm(6)
    bn.load_state_dict(flax_to_state_dict(v))
    got = bn.train()(t(x), None if mask is None else t(mask))
    np.testing.assert_allclose(n(got), np.asarray(y), **FWD)
    np.testing.assert_allclose(n(bn.mean), np.asarray(mut["batch_stats"]["mean"]), **FWD)
    np.testing.assert_allclose(n(bn.var), np.asarray(mut["batch_stats"]["var"]), **FWD)
    assert not bn.mean.requires_grad and got.requires_grad
    y_eval = jl.MaskedBatchNorm().apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, v["params"]),
         "batch_stats": mut["batch_stats"]}, jnp.asarray(x), train=False)
    np.testing.assert_allclose(n(bn.eval()(t(x))), np.asarray(y_eval), **FWD)


def test_point_mlp_with_mask_matches_flax(rng):
    """``PointMLP`` flattens the leading axes and broadcasts a ``(B, S, 1)``
    mask over them."""
    x = rng.normal(0, 1, (2, 4, 9, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, 4, 9)) > 0.3
    mask[0, 0] = False  # a group with no valid point
    jm = jl.PointMLP((8, 16))
    v = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    y, mut = jm.apply(v, jnp.asarray(x), mask=jnp.asarray(mask), train=True,
                      mutable=["batch_stats"])
    tm = tl.PointMLP(3, (8, 16))
    tm.load_state_dict(flax_to_state_dict(as_numpy_tree(v)))
    got = tm.train()(t(x), t(mask))
    np.testing.assert_allclose(n(got), np.asarray(y), **FWD)
    want = flax_to_state_dict(as_numpy_tree({"batch_stats": mut["batch_stats"]}))
    for k, w in want.items():
        np.testing.assert_allclose(n(tm.state_dict()[k]), n(w), **FWD, err_msg=k)
    # a (B, S, 1) mask broadcasts over the group axis as in Flax
    y_b, _ = jm.apply(v, jnp.asarray(x), mask=jnp.asarray(mask[..., :1]), train=True,
                      mutable=["batch_stats"])
    tm.load_state_dict(flax_to_state_dict(as_numpy_tree(v)))
    np.testing.assert_allclose(n(tm(t(x), t(mask[..., :1]))), np.asarray(y_b), **FWD)


def test_masked_mean_matches_jax(rng):
    x = rng.normal(size=(3, 6, 4)).astype(np.float32)
    mask = rng.uniform(size=(3, 6)) > 0.5
    mask[1] = False  # no valid entry: 0
    want = jl.masked_mean(jnp.asarray(x), jnp.asarray(mask), axis=1)
    got = tl.masked_mean(t(x), t(mask), dim=1)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert not got[1].any()


# ---------------------------------------------------------------------------
# data/instances.py, data/augment.py, data/iterator.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gt_size", [4, 16, 200])
def test_gather_seed_instances_matches_jax(gt_size):
    """Points and masks equal; the centre (a float32 matrix product in both)
    within 1e-6."""
    batch = _batch(seed=3)
    jb = _jbatch(batch)
    seeds = np.random.default_rng(1).integers(0, 256, (2, 12)).astype(np.int32)
    want = jinstances.gather_seed_instances(jb["xyz"], jb["inst_label"], jnp.asarray(seeds),
                                            gt_size)
    got = tinstances.gather_seed_instances(t(batch["xyz"]), t(batch["inst_label"]), t(seeds),
                                           gt_size)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(n(got[i]), np.asarray(want[i]))
    np.testing.assert_allclose(n(got[2]), np.asarray(want[2]), rtol=1e-6, atol=1e-6)
    assert got[3].any() and not got[3].all()  # fg and bg seeds both covered


def test_augment_scene_matches_jax_draws(rng):
    """Fed the JAX draws, the port's augmentation equals JAX's within 1e-6
    (``cos``/``sin`` differ by an ulp between the libraries); drawn from a
    generator it is reproducible and zeroes padded points."""
    batch = _batch(seed=5)
    key = jax.random.PRNGKey(7)
    b, npts = batch["valid"].shape
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = dict(
        theta=t(jax.random.uniform(k1, (b,), minval=0.0, maxval=2 * jnp.pi)),
        flips=t(jax.random.bernoulli(k2, 0.5, (b, 1, 2))),
        scale=t(jax.random.uniform(k3, (b, 1, 1), minval=0.9, maxval=1.1)),
        noise=t(jax.random.normal(k4, (b, npts, 3))),
    )
    want = jaugment.augment_scene(key, jnp.asarray(batch["xyz"]), jnp.asarray(batch["valid"]))
    got = taugment.augment_scene(t(batch["xyz"]), t(batch["valid"]), **draws)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    a, c = (taugment.augment_scene(t(batch["xyz"]), t(batch["valid"]),
                                   generator=torch.Generator().manual_seed(3)) for _ in range(2))
    assert torch.equal(a, c) and not a[~t(batch["valid"])].any()
    assert not torch.allclose(a, t(batch["xyz"]))
    with pytest.raises(ValueError, match="Generator"):
        taugment.augment_scene(t(batch["xyz"]))


def test_deterministic_batches_match_jax():
    """The same ``SeedSequence`` stream as the JAX package, and ``make_feed``
    yields the same batches in the same order (on the CPU, staged when
    needed)."""
    def sample(r, b):
        return tsynthetic.scene_batch(r, b, n_points=128, max_instances=4)

    ours = titerator.DeterministicBatches(sample, 2, seed=5)
    theirs = jiterator.DeterministicBatches(sample, 2, seed=5)
    for step in (0, 7):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    fed = list(titerator.make_feed(ours, 2, 5, 2, "cpu"))
    assert [i for i, _ in fed] == [2, 3, 4]
    for i, batch in fed:
        for k, v in ours.batch_at(i).items():
            np.testing.assert_array_equal(n(batch[k]), v)


# ---------------------------------------------------------------------------
# models/gspn.py: training forward and loss; train/steps.py
# ---------------------------------------------------------------------------


def test_gspn_training_forward_and_loss_match_jax(jmodel_vars):
    """``GSPN.apply(train=True)`` on the seeds' GT: ``q_mu``, ``q_logvar``,
    the generated points and the other outputs, the loss and its terms, and
    the BatchNorm statistics it leaves."""
    jm, v, batch = jmodel_vars
    jb = _jbatch(batch)
    seeds = np.asarray(jops.farthest_point_sample(S, jb["xyz"], jb["valid"], impl="xla"))
    gt = jinstances.gather_seed_instances(jb["xyz"], jb["inst_label"], jnp.asarray(seeds), G)
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (2, S, JCFG.latent_dim)))
    @jax.jit
    def jforward(xyz, seed_idx, valid, gt, eps):
        out, mut = jm.apply(v, xyz, seed_idx, valid=valid, gt_points=gt[0], gt_valid=gt[1],
                            z_eps=eps, train=True, mutable=["batch_stats"])
        return out, mut, jg.gspn_loss(out, *gt, impl="xla")[1]

    jo, mut, jmetrics = jforward(jb["xyz"], jnp.asarray(seeds), jb["valid"], gt,
                                 jnp.asarray(eps))

    tm = _port_model(v)
    tgt = tinstances.gather_seed_instances(t(batch["xyz"]), t(batch["inst_label"]), t(seeds), G)
    to = tm(t(batch["xyz"]), t(seeds), t(batch["valid"]), z_eps=t(eps), gt_points=tgt[0],
            gt_valid=tgt[1])
    for f in ("q_mu", "q_logvar", "generated", "center", "objectness", "prior_mu",
              "prior_logvar", "cond"):
        np.testing.assert_allclose(n(getattr(to, f)), np.asarray(getattr(jo, f)), **FWD,
                                   err_msg=f)
    total, metrics = tg.gspn_loss(to, *tgt)
    metrics = {k: m.detach() for k, m in metrics.items()}
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), **FWD, err_msg=k)
    assert float(total.detach()) == float(metrics["loss"])
    want = flax_to_state_dict(as_numpy_tree({"batch_stats": mut["batch_stats"]}))
    for k, w in want.items():
        np.testing.assert_allclose(n(tm.state_dict()[k]), n(w), **FWD, err_msg=k)
    # the inference forward is the prior's: no q, and the recognition
    # network is not run
    inf = tm.eval()(t(batch["xyz"]), t(seeds), t(batch["valid"]), z_eps=t(eps))
    assert inf.q_mu is None and inf.q_logvar is None
    with pytest.raises(ValueError, match="recognition"):
        tg.GSPN(gspn_config(JCFG))(t(batch["xyz"]), t(seeds), z_eps=t(eps),
                                   gt_points=tgt[0], gt_valid=tgt[1])


def _grads_by_name(grads):
    return flax_to_state_dict(as_numpy_tree({"params": grads}))


def test_gspn_gradients_match_jax(jmodel_vars):
    """Every parameter's gradient of the whole stage-1 loss (FPS seeds, GT
    pairing, training forward, ``gspn_loss``) against ``jax.value_and_grad``
    of ``make_gspn_loss_fn``."""
    jm, v, batch = jmodel_vars
    rng = jax.random.PRNGKey(21)
    jloss = jsteps.make_gspn_loss_fn(jm, S, G)
    (jtotal, (jmetrics, _)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        v["params"], v["batch_stats"], _jbatch(batch), rng)

    tm = _port_model(v)
    total, metrics = tsteps.make_gspn_loss_fn(S, G)(
        tm, titerator.to_device(batch, "cpu"), z_eps=_z_eps(rng))
    total.backward()
    metrics = {k: m.detach() for k, m in metrics.items()}
    np.testing.assert_allclose(float(metrics["loss"]), float(jtotal), **FWD)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), **FWD, err_msg=k)
    want = _grads_by_name(jgrads)
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    bench_slice.assert_grads_close(got, want)


def _bias_noise(name):
    """A Dense bias that feeds a BatchNorm, or that BatchNorm's running
    mean, which takes the bias in from the step after Adam moved it."""
    return (bench_slice._BN_FED_BIAS.search(name) is not None
            or re.search(r"\.bn_\d+\.mean$", name) is not None)


@pytest.mark.parametrize("n_steps,bn_decay", [(1, False), (3, True)])
def test_train_steps_match_optax(jmodel_vars, n_steps, bn_decay):
    """Parameters, Adam's update count and the BatchNorm statistics after
    ``n_steps`` of ``make_train_step`` against the JAX step with
    ``optax.adam`` (and, with ``bn_decay``, the momentum schedule the JAX
    step re-blends after each step and the port sets before it)."""
    jm, v, batch = jmodel_vars
    lr = 1e-3
    bn_fn = dict(decay_steps=1, decay_rate=0.5) if bn_decay else None
    tx = optax.adam(lr)
    jstep = jsteps.make_train_step(
        jsteps.make_gspn_loss_fn(jm, S, G), tx,
        bn_momentum_fn=jschedules.bn_momentum_schedule(**bn_fn) if bn_fn else None)
    state = jsteps.TrainState.create(v, tx)

    tm = _port_model(v)
    tstate = tsteps.TrainState(tm, tsteps.make_optimizer(tm, lr))
    tstep = tsteps.make_train_step(
        tsteps.make_gspn_loss_fn(S, G), lambda i: lr,
        tschedules.bn_momentum_schedule(**bn_fn) if bn_fn else None)
    tb = titerator.to_device(batch, "cpu")
    for i in range(n_steps):
        rng = jax.random.PRNGKey(100 + i)
        state, jmetrics = jstep(state, _jbatch(batch), rng)
        metrics = tstep(tstate, tb, z_eps=_z_eps(rng))
        for k in jmetrics:  # later steps start from parameters that differ by rounding
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4,
                                       err_msg=f"step {i + 1} {k}")
    assert tstate.step == int(state.step) == n_steps
    want = flax_to_state_dict(as_numpy_tree({"params": state.params,
                                             "batch_stats": state.batch_stats}))
    got = tm.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        if _bias_noise(k):
            np.testing.assert_allclose(n(got[k]), n(w), rtol=0, atol=2 * lr * n_steps,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(n(got[k]), n(w), rtol=1e-4, atol=1e-5, err_msg=k)
    moved = [k for k in want if not _bias_noise(k) and not torch.equal(got[k], want[k])
             and k.endswith(".weight")]
    assert moved  # the comparison is not of untouched weights
    back = state_dict_to_flax(got)
    assert jax.tree_util.tree_structure(back["params"]) == jax.tree_util.tree_structure(
        as_numpy_tree(state.params))


def test_tiny_training_reduces_loss():
    """The port's counterpart of ``tests/test_gspn.py``'s check: 30 steps of
    Adam at 3e-3 on one TINY batch cut the loss by 20 %."""
    model = tg.GSPN(ttrain.TINY_GSPN, recognition=True)
    tl.glorot_init_(model, torch.Generator().manual_seed(0))
    state = tsteps.TrainState(model.train(), tsteps.make_optimizer(model, 3e-3))
    step = tsteps.make_train_step(tsteps.make_gspn_loss_fn(S, G))
    batch = titerator.to_device(_batch(seed=0), "cpu")
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(state, batch, generator=gen)["loss"]) for _ in range(30)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.8, losses
    assert state.step == 30


# ---------------------------------------------------------------------------
# train/schedules.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["constant", "exp", "cosine"])
def test_lr_schedule_matches_optax(kind):
    args = argparse.Namespace(lr=1e-3, lr_schedule=kind, lr_decay_steps=3, lr_decay_rate=0.7,
                              lr_min=2e-4, steps=10)
    want = jschedules.build_lr_schedule(args)
    got = tschedules.build_lr_schedule(args)
    for step in range(14):
        w = float(want(step)) if callable(want) else want
        assert math.isclose(got(step), w, rel_tol=1e-6), (step, got(step), w)


def test_bn_momentum_schedule_matches_jax():
    want = jschedules.bn_momentum_schedule(decay_steps=4, decay_rate=0.5)
    got = tschedules.bn_momentum_schedule(decay_steps=4, decay_rate=0.5)
    for step in range(40):
        assert math.isclose(got(step), float(want(step)), rel_tol=1e-6)
    assert got(0) == 0.5 and got(10_000) == 0.99


# ---------------------------------------------------------------------------
# train/train_gspn.py
# ---------------------------------------------------------------------------

TINY_ARGS = ["--device", "cpu", "--preset", "tiny", "--batch", "2", "--num-points", "256",
             "--num-seeds", str(S), "--gt-size", str(G)]


def _lines(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


def test_train_gspn_runs_on_the_cpu(tmp_path):
    """Three steps at TINY through the entry point: metrics JSONL, a
    validation line, a checkpoint, the config and a profiler trace."""
    state = ttrain.main(TINY_ARGS + ["--steps", "3", "--log-every", "1", "--eval-every", "3",
                                     "--profile-steps", "1", "--log-dir", str(tmp_path)])
    assert state.step == 3
    lines = _lines(tmp_path / "train.jsonl")
    train = [r for r in lines if "loss" in r]
    val = [r for r in lines if "val_loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3] and [r["step"] for r in val] == [3]
    assert all(np.isfinite(r[k]) for r in lines for k in r)
    assert (tmp_path / "ckpt" / "ckpt_3.pt").exists()
    assert json.loads((tmp_path / "config.json").read_text())["model"]["latent_dim"] == 8
    assert (tmp_path / "trace" / "trace.json").exists()


def test_train_gspn_resume_is_bit_exact(tmp_path):
    """Four steps straight against two steps, a checkpoint and ``--resume``
    to four: equal parameters, running statistics and Adam moments (the
    data is a function of (seed, step) and so is each step's noise)."""
    run = TINY_ARGS + ["--ckpt-every", "1", "--log-every", "1"]
    straight = ttrain.main(run + ["--steps", "4", "--log-dir", str(tmp_path / "a")])
    ttrain.main(run + ["--steps", "2", "--log-dir", str(tmp_path / "b")])
    resumed = ttrain.main(run + ["--steps", "4", "--resume", "--log-dir", str(tmp_path / "b")])
    assert resumed.step == straight.step == 4
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    oa, ob = straight.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    for i in oa:
        for k in oa[i]:
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)
    la, lb = _lines(tmp_path / "a" / "train.jsonl"), _lines(tmp_path / "b" / "train.jsonl")
    assert [r["loss"] for r in la] == [r["loss"] for r in lb]
    assert sorted(p.name for p in (tmp_path / "b" / "ckpt").iterdir()) == [
        "ckpt_2.pt", "ckpt_3.pt", "ckpt_4.pt"]  # max_to_keep=3


def test_train_gspn_needs_a_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        ttrain.main(["--steps", "1", "--log-dir", str(tmp_path)])
    assert ttrain.parse_args([]).device == "cuda"


SHARDED_FLAGS = [["--point-sharded"], ["--data-rows", "2"]]


@pytest.mark.parametrize("preset", ["tiny", "default"])
def test_width_mult_scales_like_jax(preset):
    """``--width-mult 2``: the trainer's config and ``scale_*_widths`` of both
    stages and the pipeline are the JAX package's, widths only."""
    from gspn_tpu.models import presets as jpresets
    from gspn_tpu.models.pipeline import PipelineConfig as JPipelineConfig
    from gspn_tpu.models.rpointnet import RPointNetConfig as JRPointNetConfig
    from gspn_tpu.train.train_rpointnet import tiny_rpointnet as jtiny_rpointnet
    from gspn_tpu_torch.models import presets as tpresets
    from tests.torch_parity import pipeline_config, rpointnet_config

    jg_cfg = jtrain.TINY_GSPN if preset == "tiny" else jg.GSPNConfig()
    jr_cfg = jtiny_rpointnet(3) if preset == "tiny" else JRPointNetConfig(num_classes=3)
    args = ttrain.parse_args(["--preset", preset, "--width-mult", "2"])
    first = tsynthetic.scene_batch(np.random.default_rng(0), 1, n_points=64)
    want = gspn_config(jpresets.scale_gspn_widths(jg_cfg, 2))
    assert ttrain.model_config(args, first) == want
    assert want.latent_dim == jg_cfg.latent_dim and want.cond_dim == 2 * jg_cfg.cond_dim
    assert tpresets.scale_rpointnet_widths(rpointnet_config(jr_cfg), 2) == rpointnet_config(
        jpresets.scale_rpointnet_widths(jr_cfg, 2))
    jp = JPipelineConfig(gspn=jg_cfg, rpointnet=jr_cfg)
    assert tpresets.scale_pipeline_widths(pipeline_config(jp), 2) == pipeline_config(
        jpresets.scale_pipeline_widths(jp, 2))


@pytest.mark.parametrize("flags", SHARDED_FLAGS, ids=lambda f: f[0])
def test_train_gspn_unported_flags_raise(flags, tmp_path, monkeypatch):
    """The point-sharded flags, which raised before they were ported: on a
    one-rank world (no launcher) ``--point-sharded`` trains the run without
    it, bit for bit, and tears its world down; ``--data-rows`` alone, which
    the JAX trainer ignores, is refused (``tests/test_torch_point_sharded.py``
    runs 4 ranks)."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    argv = ["--device", "cpu", "--preset", "tiny", "--steps", "2", "--batch", "2",
            "--num-points", "128", "--num-seeds", "8", "--gt-size", "16", "--log-every", "1"]
    if flags[0] == "--data-rows":
        with pytest.raises(SystemExit, match="--data-rows requires --point-sharded"):
            ttrain.main(argv + ["--log-dir", str(tmp_path)] + flags)
        return
    got = ttrain.main(argv + ["--log-dir", str(tmp_path / "sharded")] + flags)
    assert not torch.distributed.is_initialized()
    want = ttrain.main(argv + ["--log-dir", str(tmp_path / "plain")]).model.state_dict()
    assert all(torch.equal(got.model.state_dict()[k], want[k]) for k in want)


def test_random_seed_method_matches_jax(jmodel_vars):
    """``seed_method="random"`` fed JAX's uniforms (``seed_rng, z_rng =
    split(rng)``, then ``(B, num_seeds)`` uniforms): the seeds
    ``prob_sample`` draws over the valid points, the loss, its terms and
    every gradient against ``jax.value_and_grad``; from a generator the
    uniforms come first, then the CVAE noise."""
    jm, v, batch = jmodel_vars
    rng = jax.random.PRNGKey(31)
    jloss = jsteps.make_gspn_loss_fn(jm, S, G, seed_method="random")
    (jtotal, (jmetrics, _)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        v["params"], v["batch_stats"], _jbatch(batch), rng)
    seed_rng, _ = jax.random.split(rng)
    u = jax.random.uniform(seed_rng, (2, S), jnp.float32)
    want_seeds = jops.prob_sample(jnp.asarray(batch["valid"], jnp.float32), u)
    np.testing.assert_array_equal(n(ops.prob_sample(t(batch["valid"]).float(), t(u))),
                                  np.asarray(want_seeds))
    assert batch["valid"][np.arange(2)[:, None], np.asarray(want_seeds)].all()

    tm = _port_model(v)
    loss_fn = tsteps.make_gspn_loss_fn(S, G, seed_method="random")
    tb = titerator.to_device(batch, "cpu")
    total, metrics = loss_fn(tm, tb, z_eps=_z_eps(rng), seed_u=t(u))
    total.backward()
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), **FWD,
                                   err_msg=k)
    bench_slice.assert_grads_close({k: p.grad for k, p in tm.named_parameters()},
                                   _grads_by_name(jgrads))
    gen_loss = [loss_fn(_port_model(v), tb, generator=torch.Generator().manual_seed(2))[0].item()
                for _ in range(2)]
    assert gen_loss[0] == gen_loss[1]
    with pytest.raises(ValueError, match="Generator"):
        loss_fn(_port_model(v), tb, z_eps=_z_eps(rng))


def test_unknown_seed_method_raises():
    with pytest.raises(ValueError, match="fps|random"):
        tsteps.make_gspn_loss_fn(S, G, seed_method="grid")


# ---------------------------------------------------------------------------
# The inference model stays as it was
# ---------------------------------------------------------------------------

# sha256 of init_pipeline_variables(slice_config(), manual_seed(0), 1024):
# its keys in order and their float32 bytes, as the inference-only GSPN
# drew them before the recognition network was ported
PIPELINE_DIGEST = "a8c59b47d819c0a91b8e19c49d4d3386122bd7d415ba6733fec0f0ae9b19dc53"


def test_pipeline_keys_and_seeded_draws_unchanged():
    sd = tpl.init_pipeline_variables(bench_slice.slice_config(),
                                     torch.Generator().manual_seed(0), 1024)
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(k.encode())
        h.update(v.numpy().tobytes())
    assert len(sd) == 258 and h.hexdigest() == PIPELINE_DIGEST
    assert not any(".recog_enc." in k or ".recognition." in k for k in sd)
    # the recognition modules come after the inference ones: the same
    # seeded draws for every inference parameter
    cfg = tg.GSPNConfig()
    inf = tg.GSPN(cfg)
    tr = tg.GSPN(cfg, recognition=True)
    tl.glorot_init_(inf, torch.Generator().manual_seed(0))
    tl.glorot_init_(tr, torch.Generator().manual_seed(0))
    a, b = inf.state_dict(), tr.state_dict()
    assert list(b)[:len(a)] == list(a)
    assert all(torch.equal(a[k], b[k]) for k in a)
