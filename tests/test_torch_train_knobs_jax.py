"""Both training stages with the trainers' ``--group-select strided`` and
``--width-mult 2`` against the JAX package, on the CPU at the TINY widths
(``TINY_GSPN``, ``tiny_rpointnet``; B=2 x N=256, 8 seeds, up to 4 GT
instances), with seeded NumPy inputs, Flax variables carried across by
``gspn_tpu_torch.convert`` and the noise the JAX side draws.

The knobs are set as the trainers set them: ``group_select="strided"`` on
the stage's config and, in stage 2, on the frozen GSPN's too
(``train_rpointnet._stage_knobs``); ``scale_*_widths(TINY, 2)`` on both.

Tolerances, as ``tests/test_torch_train.py`` and
``tests/test_torch_rpointnet_train.py`` hold the default knobs:

- the loss and its terms: ``rtol=1e-5, atol=1e-5``;
- gradients: ``bench_slice.assert_grads_close`` (stage 2 with the heads'
  max pool following JAX's picks, ``bench_slice.follow_max_ties``, each
  forced cell asserted a near-tie, at most ``MAX_FORCED``);
- the running statistics a loss leaves: ``rtol=1e-5, atol=1e-5``;
- one Adam step: the metrics within ``rtol=1e-4`` (stage 1) or
  ``1e-5`` (stage 2), the parameters and statistics within ``rtol=1e-4,
  atol=1e-5``, the BatchNorm-fed biases and the running means they feed
  within ``2 * lr``; so too a weight element whose gradient is float32
  rounding noise (``ROUNDING``) of the other sign in the port: Adam's first
  step moves it by ``lr`` in the sign the rounding picks (one element of ``heads.roi_mlp.dense_0``
  at ``--width-mult 2``: a gradient of 1.2e-7 in JAX and -3.7e-8 in the
  port, against the tensor's largest, 9.46).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gspn_tpu import ops as jops
from gspn_tpu.data import instances as jinstances
from gspn_tpu.data import synthetic as jsynthetic
from gspn_tpu.models import gspn as jg
from gspn_tpu.models import presets as jpresets
from gspn_tpu.models import rpointnet as jr
from gspn_tpu.train import steps as jsteps
from gspn_tpu.train import train_gspn as jtrain_gspn
from gspn_tpu.train import train_rpointnet as jtrain
from gspn_tpu_torch.convert import GSPN_TRAINING_ONLY, flax_to_state_dict
from gspn_tpu_torch.data import iterator as titerator
from gspn_tpu_torch.models import gspn as tg
from gspn_tpu_torch.models import rpointnet as tr
from gspn_tpu_torch.train import steps as tsteps
from gspn_tpu_torch.train import train_gspn as ttrain_gspn
from gspn_tpu_torch.train import train_rpointnet as ttrain
from gspn_tpu_torch.utils import bench_slice
from tests.test_torch_rpointnet_train import MAX_FORCED, _jax_draws
from tests.test_torch_train import _bias_noise, _perturbed
from tests.torch_parity import as_numpy_tree, gspn_config, n, rpointnet_config, t

FWD = dict(rtol=1e-5, atol=1e-5)
B, NPTS, S, G, I = 2, 256, 8, 16, 4  # scenes, points, seeds, GT points a seed, GT instances
LR = 1e-3
# a gradient element within this of its tensor's largest is float32 rounding
# noise (sums of hundreds of terms); at most MAX_FLIPS change sign and step apart
ROUNDING, MAX_FLIPS = 1e-6, 8
KNOBS = ("strided", "wide")
JGCFG = dataclasses.replace(jtrain_gspn.TINY_GSPN, ops_impl="xla")
JRCFG = dataclasses.replace(jtrain.tiny_rpointnet(18), ops_impl="xla")


def _knob(cfg, knob: str, scale):
    """``cfg`` as the trainers set it for ``--group-select strided``
    ("strided") or ``--width-mult 2`` ("wide"; ``scale``: the stage's
    ``presets.scale_*_widths``)."""
    if knob == "strided":
        return dataclasses.replace(cfg, group_select="strided")
    return scale(cfg, 2)


def _gcfg(knob):
    return _knob(JGCFG, knob, jpresets.scale_gspn_widths)


def _rcfg(knob):
    return _knob(JRCFG, knob, jpresets.scale_rpointnet_widths)


def _batch():
    return jsynthetic.scene_batch(np.random.default_rng(0), B, n_points=NPTS, max_instances=3,
                                  extent=2.0)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _z_eps(rng, latent_dim):
    """The CVAE noise the JAX stage-1 loss draws from ``rng``."""
    _, z_rng = jax.random.split(rng)
    return t(jax.random.normal(z_rng, (B, S, latent_dim), jnp.float32))


@pytest.fixture(scope="module", params=KNOBS)
def stage1(request):
    """``(knob, JAX GSPN, its training variables near their init, the
    batch)`` of the TINY GSPN with the knob set."""
    knob = request.param
    batch = _batch()
    jb = _jbatch(batch)
    model = jg.GSPN(_gcfg(knob))
    seed_idx = jops.farthest_point_sample(S, jb["xyz"], jb["valid"], impl="xla")
    gt_pts, gt_valid, _, _ = jinstances.gather_seed_instances(
        jb["xyz"], jb["inst_label"], seed_idx, G)
    key = jax.random.PRNGKey(0)
    v = jax.jit(lambda *a: model.init(key, *a, valid=jb["valid"], gt_points=gt_pts,
                                      gt_valid=gt_valid, z_rng=key, train=False))(
        jb["xyz"], seed_idx)
    return knob, model, _perturbed(v, 11), batch


def _port_gspn_train(knob, v):
    m = tg.GSPN(gspn_config(_gcfg(knob)), recognition=True)
    m.load_state_dict(flax_to_state_dict(as_numpy_tree(v)), strict=True)
    return m.train()


def test_stage1_knob_configs_are_the_trainers():
    """``train_gspn --group-select strided`` and ``--width-mult 2`` build the
    configs these tests hold (TINY)."""
    first = titerator.to_device(_batch(), "cpu")
    for knob, flags in (("strided", ["--group-select", "strided"]),
                        ("wide", ["--width-mult", "2"])):
        args = ttrain_gspn.parse_args(["--preset", "tiny", *flags])
        assert ttrain_gspn.model_config(args, first) == gspn_config(
            dataclasses.replace(_gcfg(knob), ops_impl="auto"))


def test_stage1_loss_and_gradients_match_jax(stage1):
    """The whole stage-1 loss (FPS seeds, GT pairing, training forward,
    ``gspn_loss``) with the knob set: the loss, its terms and every
    parameter's gradient against ``jax.value_and_grad`` of
    ``make_gspn_loss_fn``."""
    knob, jm, v, batch = stage1
    rng = jax.random.PRNGKey(21)
    jloss = jsteps.make_gspn_loss_fn(jm, S, G)
    (jtotal, (jmetrics, _)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        v["params"], v["batch_stats"], _jbatch(batch), rng)

    tm = _port_gspn_train(knob, v)
    total, metrics = tsteps.make_gspn_loss_fn(S, G)(
        tm, titerator.to_device(batch, "cpu"), z_eps=_z_eps(rng, jm.config.latent_dim))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal), **FWD)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), **FWD,
                                   err_msg=k)
    want = flax_to_state_dict(as_numpy_tree({"params": jgrads}))
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    bench_slice.assert_grads_close(got, want)


def test_stage1_adam_step_matches_optax(stage1):
    """One ``make_train_step`` step with the knob set against the JAX step
    with ``optax.adam``: the metrics, the parameters, the update count and
    the BatchNorm statistics."""
    knob, jm, v, batch = stage1
    tx = optax.adam(LR)
    jstep = jsteps.make_train_step(jsteps.make_gspn_loss_fn(jm, S, G), tx)
    rng = jax.random.PRNGKey(100)
    state, jmetrics = jstep(jsteps.TrainState.create(v, tx), _jbatch(batch), rng)

    tm = _port_gspn_train(knob, v)
    tstate = tsteps.TrainState(tm, tsteps.make_optimizer(tm, LR))
    metrics = tsteps.make_train_step(tsteps.make_gspn_loss_fn(S, G), lambda i: LR)(
        tstate, titerator.to_device(batch, "cpu"), z_eps=_z_eps(rng, jm.config.latent_dim))
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4,
                                   err_msg=k)
    assert tstate.step == int(state.step) == 1
    _assert_state_close(tm, state)


def _assert_state_close(tm, state):
    """The port's parameters and running statistics after a first step
    against the JAX state's. Adam's first step moves each element by about
    ``lr`` in its gradient's sign, whatever the gradient's size, so an
    element whose gradient is rounding noise may step the other way: the
    BatchNorm-fed biases and the means they feed, and each weight element
    whose gradient has the other sign in the port and is within
    ``ROUNDING`` of its tensor's largest in JAX (optax's first moment over
    0.1), are held within ``2 * lr``; at most ``MAX_FLIPS`` of them need
    that bound (a gradient far below Adam's epsilon, 1e-8, moves its
    element by far less than ``lr``)."""
    want = flax_to_state_dict(as_numpy_tree({"params": state.params,
                                             "batch_stats": state.batch_stats}))
    jgrads = {k: n(m) / 0.1 for k, m in flax_to_state_dict(
        as_numpy_tree({"params": state.opt_state[0].mu})).items()}
    tgrads = {k: n(p.grad) for k, p in tm.named_parameters()}
    got = tm.state_dict()
    assert got.keys() == want.keys()
    flips = 0
    for k, w in want.items():
        g, w = n(got[k]), n(w)
        loose = np.full(w.shape, _bias_noise(k))
        if k in jgrads and not _bias_noise(k):
            jg_, tg_ = jgrads[k], tgrads[k]
            loose = (np.sign(jg_) != np.sign(tg_)) & (
                np.abs(jg_) <= ROUNDING * np.abs(jg_).max())
            flips += int((loose & (np.abs(g - w) > 1e-5 + 1e-4 * np.abs(w))).sum())
        np.testing.assert_allclose(g[~loose], w[~loose], rtol=1e-4, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(g[loose], w[loose], rtol=1e-4, atol=2 * LR, err_msg=k)
    assert flips <= MAX_FLIPS, flips
    assert any(k.endswith(".weight") and not torch.equal(got[k], torch.as_tensor(n(w)))
               for k, w in want.items())


@pytest.fixture(scope="module", params=KNOBS)
def stage2(request):
    """A world as ``tests/test_torch_rpointnet_train.py``'s ``world`` with
    the knob set on both stages: the JAX TINY R-PointNet's and frozen TINY
    GSPN's variables near their init, the batch, and the knob's configs."""
    knob = request.param
    batch = _batch()
    jb = _jbatch(batch)
    key = jax.random.PRNGKey(0)
    gcfg, rcfg = _gcfg(knob), _rcfg(knob)
    jgm = jg.GSPN(gcfg)
    seeds = jops.farthest_point_sample(S, jb["xyz"], jb["valid"], impl="xla")
    gvars = jax.jit(lambda x, s, v: jgm.init(key, x, s, valid=v, z_rng=key, train=False))(
        jb["xyz"], seeds, jb["valid"])
    boxes = jnp.tile(jnp.asarray([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0]], jnp.float32), (B, 8, 1))
    rvars = jax.jit(lambda x, b, v: jr.RPointNet(rcfg).init(key, x, b, valid=v, train=False))(
        jb["xyz"], boxes, jb["valid"])
    return dict(knob=knob, gcfg=gcfg, rcfg=rcfg, batch=batch, jb=jb, jgm=jgm,
                gvars=_perturbed(gvars, 5), rvars=_perturbed(rvars, 6))


def _port_stage2(world):
    """The port's R-PointNet (training mode) and frozen GSPN (eval mode) on
    the world's variables."""
    tm = tr.RPointNet(rpointnet_config(world["rcfg"]))
    tm.load_state_dict(flax_to_state_dict(as_numpy_tree(world["rvars"])), strict=True)
    gm = tg.GSPN(gspn_config(world["gcfg"]))
    gm.load_state_dict(flax_to_state_dict(as_numpy_tree(world["gvars"]),
                                          skip=GSPN_TRAINING_ONLY), strict=True)
    return tm.train(), gm.eval()


def _jax_stage2_loss(world):
    return jsteps.make_rpointnet_loss_fn(jr.RPointNet(world["rcfg"]), I,
                                         frozen_gspn=(world["jgm"], world["gvars"], S))


def test_stage2_knob_configs_are_the_trainers():
    """``train_rpointnet --group-select strided`` and ``--width-mult 2`` build
    the R-PointNet configs these tests hold and the frozen GSPN's through
    ``_stage_knobs`` (TINY)."""
    from gspn_tpu_torch.models.presets import scale_gspn_widths

    first = titerator.to_device(_batch(), "cpu")
    for knob, flags in (("strided", ["--group-select", "strided"]),
                        ("wide", ["--width-mult", "2"])):
        args = ttrain.parse_args(["--preset", "tiny", *flags])
        assert ttrain.model_config(args, first) == rpointnet_config(
            dataclasses.replace(_rcfg(knob), ops_impl="auto"))
        assert ttrain._stage_knobs(ttrain_gspn.TINY_GSPN, args, 0, scale_gspn_widths) == (
            gspn_config(dataclasses.replace(_gcfg(knob), ops_impl="auto")))


def test_stage2_loss_and_gradients_match_jax(stage2):
    """The whole stage-2 loss over the frozen GSPN's proposals (the shared
    FPS pass, the proposals, the GT mix, the training forward, matching,
    ``rpointnet_loss``) with the knob set on both stages, fed JAX's draws:
    the loss and its terms, every parameter's gradient and the running
    statistics it leaves, against ``jax.value_and_grad``."""
    world = stage2
    v, rng = world["rvars"], jax.random.PRNGKey(7)
    (jtotal, (jmetrics, jstats)), jgrads = jax.jit(
        jax.value_and_grad(_jax_stage2_loss(world), has_aux=True))(
        v["params"], v["batch_stats"], world["jb"], rng)
    draws, jroi = _jax_draws(world, world["rcfg"], True, rng, v)

    tm, gm = _port_stage2(world)
    forced, _ = bench_slice.follow_max_ties(tm, jroi)
    total, metrics = tsteps.make_rpointnet_loss_fn(I, (gm, S))(
        tm, titerator.to_device(world["batch"], "cpu"), **draws)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal), **FWD)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), **FWD,
                                   err_msg=k)
    assert float(metrics["num_fg"]) > 0 and float(metrics["num_bg"]) > 0
    assert len(forced) == 1 and forced[0] <= MAX_FORCED, forced
    want = flax_to_state_dict(as_numpy_tree({"params": jgrads}))
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    bench_slice.assert_grads_close(got, want)
    for k, w in flax_to_state_dict(as_numpy_tree({"batch_stats": jstats})).items():
        np.testing.assert_allclose(n(tm.state_dict()[k]), n(w), **FWD, err_msg=k)


def test_stage2_adam_step_matches_optax(stage2):
    """One ``make_train_step`` step of the stage-2 loss with the knob set on
    both stages against the JAX step with ``optax.adam``, fed the JAX
    step's draws: the metrics, the parameters, the update count and the
    BatchNorm statistics."""
    world = stage2
    tx = optax.adam(LR)
    jstep = jsteps.make_train_step(_jax_stage2_loss(world), tx)
    rng = jax.random.PRNGKey(100)
    draws, jroi = _jax_draws(world, world["rcfg"], True, rng, world["rvars"])
    state, jmetrics = jstep(jsteps.TrainState.create(world["rvars"], tx), world["jb"], rng)

    tm, gm = _port_stage2(world)
    tstate = tsteps.TrainState(tm, tsteps.make_optimizer(tm, LR))
    forced, _ = bench_slice.follow_max_ties(tm, jroi)
    metrics = tsteps.make_train_step(tsteps.make_rpointnet_loss_fn(I, (gm, S)), lambda i: LR)(
        tstate, titerator.to_device(world["batch"], "cpu"), **draws)
    assert len(forced) == 1 and forced[0] <= MAX_FORCED, forced
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), **FWD, err_msg=k)
    assert tstate.step == int(state.step) == 1
    _assert_state_close(tm, state)
