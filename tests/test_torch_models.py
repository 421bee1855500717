"""The port's GSPN and R-PointNet (``gspn_tpu_torch.models``) against the JAX
package's, at the TINY pipeline's widths, with randomized Flax variables
carried across by ``gspn_tpu_torch.convert`` and the same CVAE noise.
Floats at ``rtol=1e-4, atol=1e-5`` (grid RoI points bitwise, their
interpolated features at 1e-6); indices and validity equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gspn_tpu.models import gspn as jg
from gspn_tpu.models import rpointnet as jr
from gspn_tpu_torch.convert import GSPN_TRAINING_ONLY, flax_to_state_dict
from gspn_tpu_torch.models import gspn as tg
from gspn_tpu_torch.models import rpointnet as tr
from tests.test_pipeline_eval import TINY
from tests.torch_parity import as_numpy_tree, gspn_config, n, randomized, rpointnet_config, t

TOL = dict(rtol=1e-4, atol=1e-5)


def _scene(rng, b=2, npts=128):
    xyz = rng.uniform(0, 2, (b, npts, 3)).astype(np.float32)
    valid = np.ones((b, npts), bool)
    valid[:, -20:] = False
    return xyz, valid


@pytest.mark.parametrize("masked", [False, True])
def test_gspn_inference(rng, masked):
    xyz, valid = _scene(rng)
    vm = valid if masked else None
    s = 12
    seed_idx = rng.integers(0, 100, (2, s)).astype(np.int32)
    cfg = TINY.gspn
    jm = jg.GSPN(cfg)
    v = jm.init(
        jax.random.PRNGKey(0), jnp.asarray(xyz), jnp.asarray(seed_idx),
        gt_points=jnp.zeros((2, s, 8, 3)), gt_valid=jnp.ones((2, s, 8), bool),
        z_rng=jax.random.PRNGKey(1),
    )
    v = randomized(v, 7)
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (2, s, cfg.latent_dim)))
    jo = jm.apply(v, jnp.asarray(xyz), jnp.asarray(seed_idx), valid=vm, z_eps=jnp.asarray(eps))

    tm = tg.GSPN(gspn_config(cfg))
    tm.load_state_dict(flax_to_state_dict(as_numpy_tree(v), skip=GSPN_TRAINING_ONLY))
    to = tm.eval()(t(xyz), t(seed_idx), t(valid) if masked else None, z_eps=t(eps))
    for f in ("center", "generated", "objectness", "prior_mu", "prior_logvar", "cond"):
        np.testing.assert_allclose(n(getattr(to, f)), np.asarray(getattr(jo, f)), **TOL)
    np.testing.assert_allclose(
        n(tg.proposal_boxes(to.generated, 0.1)),
        np.asarray(jg.proposal_boxes(jo.generated, 0.1)), **TOL)


def test_gspn_inference_strided_crops(rng):
    """``group_select="strided"`` context crops: the same as the JAX GSPN's,
    and not the first-K crops' outputs."""
    xyz, valid = _scene(rng, npts=400)
    seed_idx = rng.integers(0, 300, (2, 12)).astype(np.int32)
    cfg = dataclasses.replace(TINY.gspn, group_select="strided")
    jm = jg.GSPN(cfg)
    v = jm.init(
        jax.random.PRNGKey(0), jnp.asarray(xyz), jnp.asarray(seed_idx),
        gt_points=jnp.zeros((2, 12, 8, 3)), gt_valid=jnp.ones((2, 12, 8), bool),
        z_rng=jax.random.PRNGKey(1),
    )
    v = randomized(v, 9)
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (2, 12, cfg.latent_dim)))
    jo = jm.apply(v, jnp.asarray(xyz), jnp.asarray(seed_idx), valid=valid, z_eps=jnp.asarray(eps))
    sd = flax_to_state_dict(as_numpy_tree(v), skip=GSPN_TRAINING_ONLY)
    outs = []
    for select in ("strided", "first"):
        tm = tg.GSPN(dataclasses.replace(gspn_config(cfg), group_select=select))
        tm.load_state_dict(sd)
        outs.append(tm.eval()(t(xyz), t(seed_idx), t(valid), z_eps=t(eps)))
    for f in ("center", "generated", "objectness", "cond"):
        np.testing.assert_allclose(n(getattr(outs[0], f)), np.asarray(getattr(jo, f)), **TOL)
    assert not np.allclose(n(outs[0].cond), n(outs[1].cond), **TOL)


@pytest.mark.parametrize("percentile", [0.0, 0.1])
def test_proposal_boxes(rng, percentile):
    gen = rng.normal(size=(2, 5, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        n(tg.proposal_boxes(t(gen), 0.1, percentile)),
        np.asarray(jg.proposal_boxes(jnp.asarray(gen), 0.1, percentile)), **TOL)


def test_gspn_draws_noise_from_a_generator(rng):
    import torch

    xyz, valid = _scene(rng)
    tm = tg.GSPN(gspn_config(TINY.gspn)).eval()
    seed_idx = t(np.arange(12, dtype=np.int32)[None].repeat(2, 0))
    a = tm(t(xyz), seed_idx, t(valid), generator=torch.Generator().manual_seed(0))
    b = tm(t(xyz), seed_idx, t(valid), generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(n(a.generated), n(b.generated))
    with pytest.raises(ValueError, match="z_eps"):
        tm(t(xyz), seed_idx, t(valid))


def _boxes(rng, xyz, r):
    c = xyz[:, :r]
    half = rng.uniform(0.05, 0.5, (xyz.shape[0], r, 3)).astype(np.float32)
    boxes = np.concatenate([c - half, c + half], axis=-1)
    boxes[:, 0] = [5, 5, 5, 6, 6, 6]  # an empty RoI
    return boxes


@pytest.mark.parametrize("masked", [False, True])
def test_point_roi_align(rng, masked):
    xyz, valid = _scene(rng)
    boxes = _boxes(rng, xyz, 10)
    vm = valid if masked else None
    want = jr.point_roi_align(jnp.asarray(xyz), jnp.asarray(boxes), 8, vm, impl="xla")
    got = tr.point_roi_align(t(xyz), t(boxes), 8, t(valid) if masked else None)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(n(g), np.asarray(w))


@pytest.mark.parametrize("masked", [False, True])
def test_point_roi_align_strided(rng, masked):
    xyz, valid = _scene(rng, npts=400)
    boxes = _boxes(rng, xyz, 10)
    vm = valid if masked else None
    want = jr.point_roi_align(jnp.asarray(xyz), jnp.asarray(boxes), 8, vm, impl="xla",
                              select="strided")
    got = tr.point_roi_align(t(xyz), t(boxes), 8, t(valid) if masked else None,
                             select="strided")
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(n(g), np.asarray(w))
    first = tr.point_roi_align(t(xyz), t(boxes), 8, t(valid) if masked else None)
    assert not np.array_equal(n(got[0]), n(first[0]))


def test_apply_box_deltas(rng):
    boxes = _boxes(rng, rng.uniform(0, 2, (2, 10, 3)).astype(np.float32), 10)
    deltas = rng.normal(0, 2, (2, 10, 6)).astype(np.float32)
    np.testing.assert_allclose(
        n(tr.apply_box_deltas(t(boxes), t(deltas))),
        np.asarray(jr.apply_box_deltas(jnp.asarray(boxes), jnp.asarray(deltas))), **TOL)


@pytest.mark.parametrize("shared_fps", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_rpointnet_inference(rng, masked, shared_fps):
    xyz, valid = _scene(rng)
    boxes = _boxes(rng, xyz, 12)
    vm = valid if masked else None
    fps = rng.integers(0, 100, (2, 32)).astype(np.int32) if shared_fps else None
    cfg = TINY.rpointnet
    jm = jr.RPointNet(cfg)
    v = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(xyz), jnp.asarray(boxes)), 8)
    jo = jm.apply(v, jnp.asarray(xyz), jnp.asarray(boxes), valid=vm,
                  sa1_fps_idx=None if fps is None else jnp.asarray(fps))

    tm = tr.RPointNet(rpointnet_config(cfg))
    tm.load_state_dict(flax_to_state_dict(as_numpy_tree(v)))
    to = tm.eval()(t(xyz), t(boxes), t(valid) if masked else None,
                   sa1_fps_idx=None if fps is None else t(fps))
    for f in ("roi_idx", "roi_valid", "roi_xyz"):
        np.testing.assert_array_equal(n(getattr(to, f)), np.asarray(getattr(jo, f)))
    for f in ("cls_logits", "box_deltas", "mask_logits"):
        np.testing.assert_allclose(n(getattr(to, f)), np.asarray(getattr(jo, f)), **TOL)


def test_grid_factors():
    for s in (1, 6, 8, 16, 27, 30, 64, 100):
        assert tr._grid_factors(s) == jr._grid_factors(s)


@pytest.mark.parametrize("s", [8, 27, 64])
def test_roi_grid_points(rng, s):
    xyz, _ = _scene(rng)
    boxes = _boxes(rng, xyz, 7)
    boxes[:, 1, 3:] = boxes[:, 1, :3]  # a degenerate box: extent clamped to 1e-6
    world, canon = tr.roi_grid_points(t(boxes), s)
    jw, jc = jr.roi_grid_points(jnp.asarray(boxes), s)
    np.testing.assert_array_equal(n(world), np.asarray(jw))
    np.testing.assert_array_equal(n(canon), np.asarray(jc))


@pytest.mark.parametrize("masked", [False, True])
def test_interpolate_roi_features(rng, masked):
    xyz, valid = _scene(rng)
    feat = rng.standard_normal((2, 128, 5)).astype(np.float32)
    world = rng.uniform(0, 2, (2, 6, 8, 3)).astype(np.float32)
    vm = valid if masked else None
    got, gidx = tr.interpolate_roi_features(t(xyz), t(feat), t(world), t(valid) if masked else None)
    want, widx = jr.interpolate_roi_features(
        jnp.asarray(xyz), jnp.asarray(feat), jnp.asarray(world), vm, impl="xla")
    np.testing.assert_array_equal(n(gidx), np.asarray(widx))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_rpointnet_grid_inference(rng, masked):
    xyz, valid = _scene(rng)
    boxes = _boxes(rng, xyz, 12)
    vm = valid if masked else None
    cfg = dataclasses.replace(TINY.rpointnet, roi_sample="grid")
    jm = jr.RPointNet(cfg)
    v = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(xyz), jnp.asarray(boxes)), 9)
    jo = jm.apply(v, jnp.asarray(xyz), jnp.asarray(boxes), valid=vm)
    tm = tr.RPointNet(rpointnet_config(cfg))
    tm.load_state_dict(flax_to_state_dict(as_numpy_tree(v)))
    to = tm.eval()(t(xyz), t(boxes), t(valid) if masked else None)
    for f in ("roi_idx", "roi_valid", "roi_xyz"):
        np.testing.assert_array_equal(n(getattr(to, f)), np.asarray(getattr(jo, f)))
    assert not n(to.roi_valid).all()  # the empty RoI
    for f in ("cls_logits", "box_deltas", "mask_logits"):
        np.testing.assert_allclose(n(getattr(to, f)), np.asarray(getattr(jo, f)), **TOL)
