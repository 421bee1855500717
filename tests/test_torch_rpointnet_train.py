"""R-PointNet stage-2 training in the port (``gspn_tpu_torch``) against the
JAX package, on the CPU at the trainers' TINY widths (``tiny_rpointnet``
and ``TINY_GSPN``; B=2 x N=256, 8 seeds, up to 4 GT instances), with seeded
NumPy inputs, Flax variables carried across by ``gspn_tpu_torch.convert``
and the noise the JAX side draws (the GT-box jitter, the frozen GSPN's
CVAE noise, the Gumbel noise of randomized RoIs, the heads' dropout keep
masks recovered from Flax's intermediates).

Tolerances, and why:

- indices (samples, RoI picks, matches), counts and masks: equal;
- the dropout and ``prob_sample`` given the same noise: equal;
- forwards and losses: ``rtol=1e-5, atol=1e-5`` (matrix products and
  BatchNorm statistics sum in another order);
- gradients: ``bench_slice.assert_grads_close``, the port's heads' max
  pool made to pick JAX's maxima (``bench_slice.follow_max_ties``): where two
  RoI samples' values of a channel lie within the forwards' agreement,
  float32 rounding decides whether they tie exactly, both frameworks split
  a max's gradient among exact ties, and the backbone's gradient, a small
  remainder after BatchNorm's cancellation (~2e-4 against the heads'
  ~0.2), moves past ``assert_grads_close`` with one such cell. The tests
  assert each cell they force is such a near-tie, and that there are few;
- parameters after an Adam step: as ``tests/test_torch_train.py``
  (``rtol=1e-4, atol=1e-5``; BatchNorm-fed biases and the running means
  they feed within ``2 * lr`` on top of the ``rtol``: such a bias's
  gradient is rounding noise, which Adam turns into a step of up to
  ``lr`` either way). Each step starts from the JAX state after the step
  before, so no step inherits the last one's rounding. The RoI MLP's
  first running means reach ~5e4, from the zero boxes of absent GT
  instances, whose RoI-frame coordinates divide by the 1e-6 extent floor;
  the JAX package's BatchNorm counts those RoIs too.
"""

import dataclasses
import functools
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gspn_tpu import ops as jops
from gspn_tpu.data import synthetic as jsynthetic
from gspn_tpu.models import gspn as jg
from gspn_tpu.models import rpointnet as jr
from gspn_tpu.nn import layers as jl
from gspn_tpu.ops import sampling as jsampling
from gspn_tpu.train import schedules as jschedules
from gspn_tpu.train import steps as jsteps
from gspn_tpu.train import train_gspn as jtrain_gspn
from gspn_tpu.train import train_rpointnet as jtrain
from gspn_tpu_torch import ops
from gspn_tpu_torch.convert import GSPN_TRAINING_ONLY, flax_to_state_dict, state_dict_to_flax
from gspn_tpu_torch.data import iterator as titerator
from gspn_tpu_torch.models import gspn as tg
from gspn_tpu_torch.models import rpointnet as tr
from gspn_tpu_torch.nn import layers as tl
from gspn_tpu_torch.nn.pointnet2 import PointNetFPModule
from gspn_tpu_torch.ops import grouping as tgrouping
from gspn_tpu_torch.train import schedules as tschedules
from gspn_tpu_torch.train import steps as tsteps
from gspn_tpu_torch.train import train_gspn as ttrain_gspn
from gspn_tpu_torch.train import train_rpointnet as ttrain
from gspn_tpu_torch.utils import bench_slice
from tests.test_torch_train import _bias_noise, _perturbed
from tests.torch_parity import as_numpy_tree, gspn_config, n, randomized, rpointnet_config, t

FWD = dict(rtol=1e-5, atol=1e-5)
B, NPTS, S, I = 2, 256, 8, 4  # scenes, points a scene, seeds, GT instances at most
JCFG = dataclasses.replace(jtrain.tiny_rpointnet(18), ops_impl="xla")
JGCFG = dataclasses.replace(jtrain_gspn.TINY_GSPN, ops_impl="xla")
# the loss's modes: R-PointNet knobs, and whether a frozen GSPN proposes
MODES = {
    "gspn": ({}, True),
    "gt_boxes": ({}, False),
    "randomized": (dict(roi_randomize=True, head_dropout=0.5), True),
}


def _batch(seed=0):
    return jsynthetic.scene_batch(np.random.default_rng(seed), B, n_points=NPTS,
                                  max_instances=3, extent=2.0)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def world():
    """A JAX TINY R-PointNet's and a frozen TINY GSPN's variables (near
    their init, see ``_perturbed``) and the batch."""
    batch = _batch()
    jb = _jbatch(batch)
    key = jax.random.PRNGKey(0)
    jgm = jg.GSPN(JGCFG)
    seeds = jops.farthest_point_sample(S, jb["xyz"], jb["valid"], impl="xla")
    gvars = jax.jit(lambda x, s, v: jgm.init(key, x, s, valid=v, z_rng=key, train=False))(
        jb["xyz"], seeds, jb["valid"])
    boxes = jnp.tile(jnp.asarray([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0]], jnp.float32), (B, 8, 1))
    rvars = jax.jit(lambda x, b, v: jr.RPointNet(JCFG).init(key, x, b, valid=v, train=False))(
        jb["xyz"], boxes, jb["valid"])
    return dict(batch=batch, jb=jb, jgm=jgm, gvars=_perturbed(gvars, 5),
                rvars=_perturbed(rvars, 6))


def _port_rpointnet(jcfg, v):
    m = tr.RPointNet(rpointnet_config(jcfg))
    m.load_state_dict(flax_to_state_dict(as_numpy_tree(v)), strict=True)
    return m.train()


def _port_gspn(v):
    m = tg.GSPN(gspn_config(JGCFG))
    m.load_state_dict(flax_to_state_dict(as_numpy_tree(v), skip=GSPN_TRAINING_ONLY), strict=True)
    return m.eval()


def _jax_loss_fn(world, mode):
    knobs, frozen = MODES[mode]
    jcfg = dataclasses.replace(JCFG, **knobs)
    fz = (world["jgm"], world["gvars"], S) if frozen else None
    return jcfg, jsteps.make_rpointnet_loss_fn(jr.RPointNet(jcfg), I, frozen_gspn=fz)


@functools.lru_cache(maxsize=None)
def _jax_heads(jcfg):
    """A jitted training apply of a JAX R-PointNet that returns its heads'
    intermediates."""
    jm = jr.RPointNet(jcfg)
    return jax.jit(lambda v, x, r, val, i, rngs: jm.apply(
        v, x, r, valid=val, train=True, rngs=rngs, sa1_fps_idx=i,
        capture_intermediates=True, mutable=["batch_stats", "intermediates"],
    )[1]["intermediates"]["heads"])


def _jax_draws(world, jcfg, frozen, rng, v):
    """What ``make_rpointnet_loss_fn`` draws from ``rng`` at the variables
    ``v``, as the port's keyword arguments (the box jitter's N(0,1) noise,
    the frozen GSPN's CVAE noise, the Gumbel noise from the root scope's
    ``make_rng("roi")`` and the heads' dropout keep masks: where Flax's
    Dropout outputs are nonzero), and the RoI MLP's output that the heads'
    max pool reads, from a training apply on the loss's own RoIs and rngs."""
    jb = world["jb"]
    jitter_rng, drop_rng, roi_rng, z_rng = jax.random.split(rng, 4)
    box_noise = jax.random.normal(jitter_rng, (B, I, 6), jnp.float32)
    draws = {"box_noise": t(box_noise)}
    jm = jr.RPointNet(jcfg)
    gt_boxes, _, present = jr.instance_gt_boxes(jb["xyz"], jb["inst_label"], jb["sem_label"], I)
    rois = jnp.where(present[..., None], gt_boxes + box_noise * 0.05, 0.0)
    sa1_idx = None
    if frozen:
        z = jax.random.normal(z_rng, (B, S, JGCFG.latent_dim), jnp.float32)
        draws["z_eps"] = t(z)
        fps_all = jops.farthest_point_sample(jcfg.sa_layers[0].npoint, jb["xyz"], jb["valid"],
                                             impl="xla")
        sa1_idx = fps_all
        gen = jax.jit(lambda x, s, v, z: world["jgm"].apply(
            world["gvars"], x, s, valid=v, train=False, z_eps=z).generated)(
            jb["xyz"], fps_all[:, :S], jb["valid"], z)
        rois = jnp.concatenate([jg.proposal_boxes(gen, jcfg.box_margin), rois], 1)
    rngs = {"dropout": drop_rng, "roi": roi_rng}
    if jcfg.roi_randomize:
        key = jm.apply({}, rngs=rngs, method=lambda mod: mod.make_rng("roi"))
        draws["gumbel"] = t(jax.random.gumbel(key, (B, rois.shape[1], NPTS), jnp.float32))
    heads = _jax_heads(jcfg)(v, jb["xyz"], rois, jb["valid"], sa1_idx, rngs)
    if jcfg.head_dropout > 0:
        draws["dropout_keep"] = {
            head: [t(np.asarray(heads[head][f"Dropout_{i}"]["__call__"][0]) != 0)
                   for i in range(len(getattr(jcfg, f"{head}_fc")))]
            for head in ("cls", "box")}
    return draws, np.asarray(heads["roi_mlp"]["__call__"][0])


MAX_FORCED = 8  # of the heads' B * R * C = 768 max-pool cells (1-5 seen)


@pytest.fixture(scope="module")
def jax_runs(world):
    """``run(mode) -> (total, metrics, batch_stats, grads, draws,
    roi_mlp_out)`` of the JAX loss, each mode jitted once."""
    cache = {}

    def run(mode):
        if mode not in cache:
            jcfg, jloss = _jax_loss_fn(world, mode)
            v, rng = world["rvars"], jax.random.PRNGKey(7)
            (total, (metrics, stats)), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
                v["params"], v["batch_stats"], world["jb"], rng)
            cache[mode] = (total, metrics, stats, grads,
                           *_jax_draws(world, jcfg, MODES[mode][1], rng, v))
        return cache[mode]

    return run


# ---------------------------------------------------------------------------
# ops/sampling.py
# ---------------------------------------------------------------------------


def test_prob_sample_matches_jax(rng):
    """Indices equal to JAX's on unnormalized weights with zero runs, a
    valid mask's 0/1 weights, and uniforms at 0 and just below 1."""
    w = rng.uniform(size=(3, 50)).astype(np.float32)
    w[w < 0.3] = 0.0
    w[2] = rng.uniform(size=50) > 0.4
    r = rng.uniform(size=(3, 40)).astype(np.float32)
    r[:, 0] = 0.0
    r[:, 1] = np.float32(1.0) - np.finfo(np.float32).epsneg
    want = jsampling.prob_sample(jnp.asarray(w), jnp.asarray(r))
    got = ops.prob_sample(t(w), t(r))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert (w[np.arange(3)[:, None], n(got)[:, 2:]] > 0).all()


def test_random_prob_sample_draws_from_the_generator():
    w = torch.zeros(2, 30)
    w[:, 5:9] = 1.0
    a, b = (ops.random_prob_sample(w, 12, torch.Generator().manual_seed(4)) for _ in range(2))
    assert a.shape == (2, 12) and torch.equal(a, b)
    assert ((a >= 5) & (a < 9)).all()


# ---------------------------------------------------------------------------
# nn/layers.py: FCLayers with dropout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.3, 0.5])
def test_dropout_matches_flax_exactly(rng, rate):
    """Given Flax's keep mask, the port's dropout is Flax's output bit for
    bit (a true division by ``1 - rate``)."""
    x = rng.normal(size=(4, 5, 7)).astype(np.float32)
    y = np.asarray(fnn.Dropout(rate).apply({}, jnp.asarray(x), deterministic=False,
                                           rngs={"dropout": jax.random.PRNGKey(2)}))
    keep = y != 0
    assert 0.0 < keep.mean() < 1.0
    np.testing.assert_array_equal(n(tl.dropout(t(x), rate, t(keep))), y)
    a, b = (tl.dropout(t(x), rate, generator=torch.Generator().manual_seed(1)) for _ in range(2))
    assert torch.equal(a, b) and 0.0 < (a != 0).float().mean() < 1.0
    assert not tl.dropout(t(x), 1.0).any()
    with pytest.raises(ValueError, match="Generator"):
        tl.dropout(t(x), rate)


@pytest.mark.parametrize("shape", [(6, 9), (2, 5, 9)], ids=["rows", "rois"])
def test_fc_layers_dropout_matches_flax(rng, shape):
    """Training-mode dropout after each hidden ReLU with Flax's keep masks,
    on rows and on the heads' (B, R, C) pooled RoI features; none in eval
    mode; the state-dict keys are those of a head without dropout."""
    x = rng.normal(size=shape).astype(np.float32)
    jm = jl.FCLayers((8, 16), 5, dropout=0.5)
    v = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    y, mut = jm.apply(v, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(3)},
                      capture_intermediates=True, mutable=["intermediates"])
    inter = mut["intermediates"]
    keep = [t(np.asarray(inter[f"Dropout_{i}"]["__call__"][0]) != 0) for i in range(2)]
    tm = tl.FCLayers(9, (8, 16), 5, dropout=0.5)
    tm.load_state_dict(flax_to_state_dict(as_numpy_tree(v)), strict=True)
    np.testing.assert_allclose(n(tm.train()(t(x), keep)), np.asarray(y), **FWD)
    np.testing.assert_allclose(n(tm.eval()(t(x))),
                               np.asarray(jm.apply(v, jnp.asarray(x), train=False)), **FWD)
    assert tm.state_dict().keys() == tl.FCLayers(9, (8, 16), 5).state_dict().keys()


# ---------------------------------------------------------------------------
# models/rpointnet.py: randomized RoI sampling, boxes, matching, loss
# ---------------------------------------------------------------------------


def test_point_roi_align_randomized_matches_jax(rng):
    """The Gumbel top-k branch fed ``jax.random.gumbel``'s noise: indices,
    validity, capped counts and the RoI-frame coordinates equal to JAX's,
    with boxes holding many points, fewer than S and none."""
    s = 16
    xyz = rng.uniform(0, 1, (2, 200, 3)).astype(np.float32)
    valid = rng.uniform(size=(2, 200)) > 0.2
    c = rng.uniform(0.2, 0.8, (2, 5, 3)).astype(np.float32)
    half = np.array([0.4, 0.3, 0.1, 0.05, 0.2], np.float32)[None, :, None]
    boxes = np.concatenate([c - half, c + half], -1)
    boxes[:, 4] = [3.0, 3.0, 3.0, 3.5, 3.5, 3.5]  # empty
    key = jax.random.PRNGKey(3)
    want = jr.point_roi_align(jnp.asarray(xyz), jnp.asarray(boxes), s, jnp.asarray(valid),
                              rng=key)
    g = t(jax.random.gumbel(key, (2, 5, 200), jnp.float32))
    got = tr.point_roi_align(t(xyz), t(boxes), s, t(valid), gumbel=g, randomize=True)
    for i, (a, w) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_array_equal(n(a), np.asarray(w), err_msg=str(i))
    cnt = n(got[3])
    assert (cnt == s).any() and ((cnt > 0) & (cnt < s)).any() and (cnt == 0).any()
    again = [tr.point_roi_align(t(xyz), t(boxes), s, t(valid), randomize=True,
                                generator=torch.Generator().manual_seed(5))[0] for _ in range(2)]
    assert torch.equal(*again)
    inside = ops.box_contains(t(boxes), t(xyz), t(valid))
    picked = torch.gather(inside, -1, again[0].long())
    assert picked[t(cnt) > 0].all()


def test_instance_gt_boxes_matches_jax():
    batch = _batch(seed=2)
    jb = _jbatch(batch)
    want = jr.instance_gt_boxes(jb["xyz"], jb["inst_label"], jb["sem_label"], 5)
    got = tr.instance_gt_boxes(t(batch["xyz"]), t(batch["inst_label"]), t(batch["sem_label"]), 5)
    for a, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(n(a), np.asarray(w))
    assert got[1].dtype == torch.int32 and got[2].any() and not got[2].all()


def _boxes(rng, shape):
    c = rng.uniform(0, 2, shape + (3,)).astype(np.float32)
    h = rng.uniform(0.05, 0.6, shape + (3,)).astype(np.float32)
    return np.concatenate([c - h, c + h], -1)


def test_box_deltas_between_matches_jax(rng):
    a, b = _boxes(rng, (3, 7)), _boxes(rng, (3, 7))
    want = jr.box_deltas_between(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(n(tr.box_deltas_between(t(a), t(b))), np.asarray(want), **FWD)
    back = tr.apply_box_deltas(t(a), tr.box_deltas_between(t(a), t(b)))
    np.testing.assert_allclose(n(back), b, rtol=1e-5, atol=1e-5)


def _match_inputs(rng):
    """RoIs about GT boxes (near-copies, overlaps, strays), GT instance 2
    absent, instance 3 a copy of instance 1 (argmax ties go to the first)."""
    gt = _boxes(rng, (2, 4))
    gt[:, 3] = gt[:, 1]
    present = np.array([[True, True, False, True]] * 2)
    cls = rng.integers(1, 18, (2, 4)).astype(np.int32)
    rois = np.concatenate([gt + rng.normal(0, 0.03, gt.shape).astype(np.float32),
                           gt + rng.normal(0, 0.3, gt.shape).astype(np.float32),
                           _boxes(rng, (2, 4))], 1)
    roi_valid = rng.uniform(size=(2, 12)) > 0.15
    return rois, roi_valid, gt, cls, present


def test_match_rois_matches_jax(rng):
    args = _match_inputs(rng)
    want = jr.match_rois(*map(jnp.asarray, args), 0.5, 0.25)
    got = tr.match_rois(*map(t, args), 0.5, 0.25)
    for f in ("matched_inst", "is_fg", "is_bg", "cls_target"):
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    for f in ("matched_iou", "box_target"):
        np.testing.assert_allclose(n(getattr(got, f)), np.asarray(getattr(want, f)), **FWD,
                                   err_msg=f)
    assert got.is_fg.any() and got.is_bg.any() and not (n(got.matched_inst) == 3).any()


def test_rpointnet_loss_matches_jax(rng):
    """The loss and its terms on random head outputs and JAX's match, and
    the gradients of the logits and deltas."""
    rois, roi_valid, gt, cls, present = _match_inputs(rng)
    jmatch = jr.match_rois(*map(jnp.asarray, (rois, roi_valid, gt, cls, present)), 0.5, 0.25)
    r, s = rois.shape[1], 6
    logits = rng.normal(0, 2, (2, r, 19)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (2, r, 6)).astype(np.float32)
    mask_logits = rng.normal(0, 3, (2, r, s)).astype(np.float32)
    roi_idx = rng.integers(0, 40, (2, r, s)).astype(np.int32)
    inst = rng.integers(0, 5, (2, 40)).astype(np.int32)

    def jloss(lg, dl, ml):
        out = jr.RoIOutputs(cls_logits=lg, box_deltas=dl, mask_logits=ml,
                            roi_idx=jnp.asarray(roi_idx), roi_xyz=None,
                            roi_valid=jnp.asarray(roi_valid))
        return jr.rpointnet_loss(out, jmatch, jnp.asarray(inst), box_weight=0.5)

    (jtotal, jmetrics), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(mask_logits))
    tmatch = tr.RoIMatch(*(t(np.asarray(getattr(jmatch, f.name)))
                           for f in dataclasses.fields(tr.RoIMatch)))
    leaves = [t(a).requires_grad_() for a in (logits, deltas, mask_logits)]
    out = tr.RoIOutputs(*leaves, t(roi_idx), None, t(roi_valid))
    total, metrics = tr.rpointnet_loss(out, tmatch, t(inst), box_weight=0.5)
    total.backward()
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), **FWD,
                                   err_msg=k)
    for leaf, g in zip(leaves, jgrads, strict=True):
        np.testing.assert_allclose(n(leaf.grad), np.asarray(g), **FWD)
    assert float(metrics["num_fg"]) > 0 and float(metrics["num_bg"]) > 0


# ---------------------------------------------------------------------------
# train/steps.py: make_rpointnet_loss_fn, make_train_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_rpointnet_loss_fn_matches_jax(world, jax_runs, mode):
    """The whole stage-2 loss (GT boxes and their jitter; with the frozen
    GSPN, the shared FPS pass, its proposals and the GT mix; randomized RoIs
    and head dropout in "randomized") fed JAX's draws: the loss and its
    terms, every parameter's gradient and the running statistics it
    leaves."""
    jtotal, jmetrics, jstats, jgrads, draws, jroi = jax_runs(mode)
    knobs, frozen = MODES[mode]
    tm = _port_rpointnet(dataclasses.replace(JCFG, **knobs), world["rvars"])
    forced, _ = bench_slice.follow_max_ties(tm, jroi)
    fz = (_port_gspn(world["gvars"]), S) if frozen else None
    total, metrics = tsteps.make_rpointnet_loss_fn(I, fz)(
        tm, titerator.to_device(world["batch"], "cpu"), **draws)
    total.backward()
    metrics = {k: m.detach() for k, m in metrics.items()}
    np.testing.assert_allclose(float(total.detach()), float(jtotal), **FWD)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), **FWD, err_msg=k)
    assert float(metrics["num_fg"]) > 0
    assert (float(metrics["num_bg"]) > 0) == frozen
    assert len(forced) == 1 and forced[0] <= MAX_FORCED, forced
    want = flax_to_state_dict(as_numpy_tree({"params": jgrads}))
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    bench_slice.assert_grads_close(got, want)
    for k, w in flax_to_state_dict(as_numpy_tree({"batch_stats": jstats})).items():
        np.testing.assert_allclose(n(tm.state_dict()[k]), n(w), **FWD, err_msg=k)


def test_rpointnet_loss_fn_draws_from_the_generator(world):
    """Without noise passed in, every draw comes from the generator: the
    same generator seed gives the same loss; the loss raises without
    either."""
    knobs, _ = MODES["randomized"]
    cfg = dataclasses.replace(JCFG, **knobs)
    batch = titerator.to_device(world["batch"], "cpu")
    loss_fn = tsteps.make_rpointnet_loss_fn(I, (_port_gspn(world["gvars"]), S))
    losses = [loss_fn(_port_rpointnet(cfg, world["rvars"]), batch,
                      generator=torch.Generator().manual_seed(9))[0].item() for _ in range(2)]
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    with pytest.raises(ValueError, match="Generator"):
        loss_fn(_port_rpointnet(cfg, world["rvars"]), batch)
    with pytest.raises(ValueError, match="train"):
        loss_fn(_port_rpointnet(cfg, world["rvars"]).eval(), batch)


LR = 1e-3
BN_DECAY = dict(decay_steps=1, decay_rate=0.5)


@pytest.fixture(scope="module")
def jax_steps(world):
    """Three JAX steps (``optax.adam``, the bn-decay schedule) of the loss
    with the frozen GSPN: the state and metrics after each, each step's
    draws and its RoI MLP output."""
    jcfg, jloss = _jax_loss_fn(world, "gspn")
    tx = optax.adam(LR)
    jstep = jsteps.make_train_step(jloss, tx,
                                   bn_momentum_fn=jschedules.bn_momentum_schedule(**BN_DECAY))
    state = jsteps.TrainState.create(world["rvars"], tx)
    out = []
    for i in range(3):
        rng = jax.random.PRNGKey(100 + i)
        v = {"params": state.params, "batch_stats": state.batch_stats}
        draws, roi_out = _jax_draws(world, jcfg, True, rng, v)
        state, metrics = jstep(state, world["jb"], rng)
        out.append((state, metrics, draws, roi_out))
    return out


def _load_jax_state(tstate, state):
    """The JAX train state ``state`` into the port's: parameters, running
    statistics, Adam's moments and the update count."""
    tm, adam = tstate.model, state.opt_state[0]
    tm.load_state_dict(flax_to_state_dict(as_numpy_tree(
        {"params": state.params, "batch_stats": state.batch_stats})), strict=True)
    mu = flax_to_state_dict(as_numpy_tree({"params": adam.mu}))
    nu = flax_to_state_dict(as_numpy_tree({"params": adam.nu}))
    for k, p in tm.named_parameters():
        tstate.optimizer.state[p] = {"step": torch.tensor(float(adam.count)),
                                     "exp_avg": mu[k], "exp_avg_sq": nu[k]}
    tstate.step = int(state.step)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_rpointnet_train_steps_match_optax(world, jax_steps, n_steps):
    """Each of ``n_steps`` steps of ``make_train_step`` against the JAX step
    with ``optax.adam`` and the bn-decay schedule, from the same state:
    before step k > 1 the JAX state after step k - 1 is loaded into the
    port, so no step inherits the last one's rounding. After each step:
    the metrics, every gradient (JAX's recovered from optax's first
    moments, as Adam's update hides a gradient's scale), the parameters,
    the update count and the BatchNorm statistics."""
    tm = _port_rpointnet(JCFG, world["rvars"])
    tstate = tsteps.TrainState(tm, tsteps.make_optimizer(tm, LR))
    tstep = tsteps.make_train_step(tsteps.make_rpointnet_loss_fn(I, (_port_gspn(world["gvars"]), S)),
                                   lambda i: LR, tschedules.bn_momentum_schedule(**BN_DECAY))
    tb = titerator.to_device(world["batch"], "cpu")
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    for i in range(n_steps):
        if i:
            _load_jax_state(tstate, jax_steps[i - 1][0])
        state, jmetrics, draws, jroi = jax_steps[i]
        forced, hook = bench_slice.follow_max_ties(tm, jroi)
        metrics = tstep(tstate, tb, **draws)
        hook.remove()
        assert len(forced) == 1 and forced[0] <= MAX_FORCED, forced
        for k in jmetrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), **FWD,
                                       err_msg=f"step {i + 1} {k}")
        assert tstate.step == int(state.step) == i + 1
        want = flax_to_state_dict(as_numpy_tree({"params": state.params,
                                                 "batch_stats": state.batch_stats}))
        got = tm.state_dict()
        assert got.keys() == want.keys()
        for k, w in want.items():
            atol = 2 * LR if _bias_noise(k) else 1e-5
            np.testing.assert_allclose(n(got[k]), n(w), rtol=1e-4, atol=atol,
                                       err_msg=f"step {i + 1} {k}")
        mu = flax_to_state_dict(as_numpy_tree({"params": state.opt_state[0].mu}))
        prev = (flax_to_state_dict(as_numpy_tree({"params": jax_steps[i - 1][0].opt_state[0].mu}))
                if i else dict.fromkeys(mu, 0.0))
        bench_slice.assert_grads_close(  # JAX's gradient, from optax's first moments
            {k: p.grad for k, p in tm.named_parameters()},
            {k: (mu[k] - 0.9 * prev[k]) / 0.1 for k in mu})
    assert any(k.endswith(".weight") and not torch.equal(got[k], init[k]) for k in want)


# ---------------------------------------------------------------------------
# The plain path stays plain; convert.py
# ---------------------------------------------------------------------------


@pytest.fixture
def index_add_impls(monkeypatch):
    """The ``impl`` of every ``index_add_rows`` call a gather's backward
    makes."""
    calls = []
    real = tgrouping.index_add_rows

    def spy(*args, impl="auto", **kw):
        calls.append(impl)
        return real(*args, impl=impl, **kw)

    monkeypatch.setattr(tgrouping, "index_add_rows", spy)
    return calls


def test_plain_fp_backward_calls_index_add_plain(rng, index_add_impls):
    """A plain FP module's "exact" interpolation takes its gather backward
    through ``index_add_rows(impl="plain")``: on the card it launches no
    kernel."""
    fp = PointNetFPModule(16 + 5, (12,), ops_impl="plain", interp="exact").train()
    xyz1 = t(rng.uniform(size=(2, 30, 3)).astype(np.float32))
    xyz2 = t(rng.uniform(size=(2, 9, 3)).astype(np.float32))
    p1 = t(rng.normal(size=(2, 30, 5)).astype(np.float32)).requires_grad_()
    p2 = t(rng.normal(size=(2, 9, 16)).astype(np.float32)).requires_grad_()
    fp(xyz1, xyz2, p1, p2).square().sum().backward()
    assert index_add_impls == ["plain"]
    assert p2.grad.abs().sum() > 0


def test_plain_rpointnet_step_takes_every_backward_plain(world, index_add_impls):
    """A whole stage-2 loss and backward of a plain R-PointNet: every gather
    backward on the plain route (SA2's grouping, FP1-FP2's sources, the
    RoIAlign gather)."""
    cfg = dataclasses.replace(rpointnet_config(JCFG), ops_impl="plain")
    tm = tr.RPointNet(cfg)
    tm.load_state_dict(flax_to_state_dict(as_numpy_tree(world["rvars"])))
    total, _ = tsteps.make_rpointnet_loss_fn(I)(tm.train(), titerator.to_device(world["batch"], "cpu"),
                                               generator=torch.Generator().manual_seed(0))
    total.backward()
    assert index_add_impls == ["plain"] * 4


def test_convert_carries_rpointnet_variables():
    """A standalone R-PointNet's Flax variables go into the port's state
    dict strictly and come back unchanged."""
    boxes = jnp.zeros((1, 2, 6), jnp.float32).at[..., 3:].set(1.0)
    xyz = jnp.asarray(np.random.default_rng(0).uniform(size=(1, 128, 3)), jnp.float32)
    v = jax.jit(lambda x, b: jr.RPointNet(JCFG).init(jax.random.PRNGKey(1), x, b))(xyz, boxes)
    v = as_numpy_tree(randomized(v, 3))
    module = tr.RPointNet(rpointnet_config(JCFG))
    module.load_state_dict(flax_to_state_dict(v), strict=True)
    back = state_dict_to_flax(module.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v), strict=True):
        np.testing.assert_array_equal(a, b)
    assert "batch_stats" in back and "heads" in back["params"]


# ---------------------------------------------------------------------------
# train/train_rpointnet.py
# ---------------------------------------------------------------------------

TINY_ARGS = ["--device", "cpu", "--preset", "tiny", "--batch", "2", "--num-points", "256",
             "--num-seeds", str(S), "--max-instances", str(I)]


def _lines(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def gspn_ckpt(tmp_path_factory):
    """The checkpoint directory of one TINY ``train_gspn`` step."""
    d = tmp_path_factory.mktemp("gspn")
    ttrain_gspn.main(["--device", "cpu", "--preset", "tiny", "--batch", "2", "--num-points",
                      "256", "--num-seeds", str(S), "--gt-size", "16", "--steps", "1",
                      "--log-dir", str(d)])
    return d / "ckpt"


def test_train_rpointnet_runs_on_the_cpu(tmp_path):
    """Three GT-box steps at TINY through the entry point: metrics JSONL, a
    validation line, a checkpoint, the config and a profiler trace."""
    state = ttrain.main(TINY_ARGS + ["--steps", "3", "--log-every", "1", "--eval-every", "3",
                                     "--profile-steps", "1", "--log-dir", str(tmp_path)])
    assert state.step == 3
    lines = _lines(tmp_path / "train.jsonl")
    train = [r for r in lines if "loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3]
    assert [r["step"] for r in lines if "val_loss" in r] == [3]
    assert all(np.isfinite(r[k]) for r in lines for k in r)
    assert all(r["num_fg"] > 0 for r in train)
    assert (tmp_path / "ckpt" / "ckpt_3.pt").exists()
    assert json.loads((tmp_path / "config.json").read_text())["model"]["roi_samples"] == 16
    assert (tmp_path / "trace" / "trace.json").exists()


def test_train_rpointnet_reads_train_gspns_checkpoint(gspn_ckpt, tmp_path):
    """``--gspn-ckpt`` loads the newest ``train_gspn`` checkpoint into an
    inference GSPN (the recognition network dropped) and trains over its
    proposals mixed with the GT boxes."""
    gmodel = ttrain.load_frozen_gspn(str(gspn_ckpt), ttrain_gspn.TINY_GSPN, "cpu")
    assert not gmodel.training
    saved = torch.load(gspn_ckpt / "ckpt_1.pt", weights_only=True)["model"]
    kept = {k: v for k, v in saved.items() if not k.startswith(GSPN_TRAINING_ONLY)}
    assert len(kept) < len(saved) and gmodel.state_dict().keys() == kept.keys()
    assert all(torch.equal(gmodel.state_dict()[k], v) for k, v in kept.items())
    state = ttrain.main(TINY_ARGS + ["--steps", "2", "--log-every", "1", "--gspn-ckpt",
                                     str(gspn_ckpt), "--log-dir", str(tmp_path)])
    lines = _lines(tmp_path / "train.jsonl")
    assert state.step == 2 and all(r["num_bg"] > 0 and r["num_fg"] > 0 for r in lines)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ttrain.load_frozen_gspn(str(tmp_path / "none"), ttrain_gspn.TINY_GSPN, "cpu")


def test_train_rpointnet_resume_is_bit_exact(gspn_ckpt, tmp_path):
    """Four steps straight against two, a checkpoint and ``--resume`` to
    four, over the frozen GSPN's proposals: equal parameters, running
    statistics, Adam moments and losses."""
    run = TINY_ARGS + ["--gspn-ckpt", str(gspn_ckpt), "--ckpt-every", "1", "--log-every", "1"]
    straight = ttrain.main(run + ["--steps", "4", "--log-dir", str(tmp_path / "a")])
    ttrain.main(run + ["--steps", "2", "--log-dir", str(tmp_path / "b")])
    resumed = ttrain.main(run + ["--steps", "4", "--resume", "--log-dir", str(tmp_path / "b")])
    assert resumed.step == straight.step == 4
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    oa, ob = straight.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i])
    la, lb = _lines(tmp_path / "a" / "train.jsonl"), _lines(tmp_path / "b" / "train.jsonl")
    assert [r["loss"] for r in la] == [r["loss"] for r in lb]


def test_train_rpointnet_needs_a_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="train_rpointnet: .*--device cpu"):
        ttrain.main(["--steps", "1", "--log-dir", str(tmp_path)])
    assert ttrain.parse_args([]).device == "cuda"


RP_SHARDED_FLAGS = [(["--point-sharded"], None),
                    (["--data-rows", "2"], "--data-rows requires --point-sharded")]


def test_train_rpointnet_width_mult_scales_both_stages(tmp_path):
    """``--width-mult 2`` on a ``--width-mult 2`` stage-1 checkpoint: stage 2
    trains the JAX trainer's scaled R-PointNet over a frozen GSPN scaled the
    same way (unscaled, the checkpoint would not load into it)."""
    from gspn_tpu.models.presets import scale_rpointnet_widths

    common = ["--device", "cpu", "--preset", "tiny", "--steps", "1", "--batch", "2",
              "--num-points", "128", "--num-seeds", "8", "--log-every", "1", "--width-mult", "2"]
    ttrain_gspn.main(common + ["--gt-size", "16", "--log-dir", str(tmp_path / "g")])
    state = ttrain.main(common + ["--num-classes", "3", "--gspn-ckpt", str(tmp_path / "g" / "ckpt"),
                                  "--log-dir", str(tmp_path / "r")])
    want = rpointnet_config(scale_rpointnet_widths(jtrain.tiny_rpointnet(3), 2))
    assert state.model.config == want and state.step == 1
    saved = json.loads((tmp_path / "r" / "config.json").read_text())["model"]
    assert saved["roi_mlp"] == list(want.roi_mlp) and saved["__dataclass__"] == "RPointNetConfig"


@pytest.mark.parametrize("flags,said", RP_SHARDED_FLAGS, ids=lambda f: f[0] if f else "")
def test_train_rpointnet_unported_flags_raise(flags, said, tmp_path, monkeypatch):
    """The point-sharded flags, which raised before they were ported: on a
    one-rank world (no launcher) ``--point-sharded`` over a frozen GSPN
    trains the run without it, bit for bit; ``--data-rows`` alone is
    refused (``tests/test_torch_point_sharded.py`` runs 4 ranks)."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    common = ["--device", "cpu", "--preset", "tiny", "--steps", "1", "--batch", "2",
              "--num-points", "128", "--num-seeds", "8", "--log-every", "1"]
    if said is not None:
        with pytest.raises(SystemExit, match=said):
            ttrain.main(common + ["--log-dir", str(tmp_path)] + flags)
        return
    ttrain_gspn.main(common + ["--gt-size", "16", "--log-dir", str(tmp_path / "g")])
    argv = common + ["--num-classes", "3", "--max-instances", "4",
                     "--gspn-ckpt", str(tmp_path / "g" / "ckpt")]
    got = ttrain.main(argv + ["--log-dir", str(tmp_path / "sharded")] + flags)
    assert not torch.distributed.is_initialized()
    want = ttrain.main(argv + ["--log-dir", str(tmp_path / "plain")]).model.state_dict()
    assert all(torch.equal(got.model.state_dict()[k], want[k]) for k in want)


def test_train_rpointnet_presets_and_defaults_match_jax():
    """The tiny preset is the JAX trainer's, and every flag the JAX trainer
    takes has its default here (the port adds ``--device``)."""
    assert ttrain.tiny_rpointnet(18) == rpointnet_config(jtrain.tiny_rpointnet(18))
    ours, theirs = vars(ttrain.parse_args([])), vars(jtrain.parse_args([]))
    assert set(ours) - set(theirs) == {"device"} and set(theirs) <= set(ours)
    assert {k: ours[k] for k in theirs} == theirs
