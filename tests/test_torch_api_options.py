"""The library options and helpers the port carries from the JAX package's
API (``tests/test_torch_api.py`` holds the signatures), each against its
JAX function on the same NumPy inputs, on the CPU: ``PointMLP``'s
``bn_momentum`` and ``last_activation``, ``FCLayers(use_bn=True)`` through
``convert.py``, ``query_box_group(with_coords=False)``,
``query_ball_multi_v2``, ``augment_scene``'s five options, and the helpers
(``load_config``, ``shared_fps_indices``, ``gather_roi_features``,
``optax_sigmoid_bce``, ``native.available``, the trainer's
``device_batch`` / ``data_iterator`` / ``restore_or_init``,
``DeterministicBatches.iterate``, ``CheckpointManager.restore_params``,
``utils.profiling``'s ``trace`` / ``annotate`` / ``StepTimer``), plus the
NMS kernel route's box limit.

Tolerances: indices, counts and masks equal; layer outputs and running
statistics ``rtol=1e-5, atol=1e-5`` (matrix products and BatchNorm sums in
another order); the augmentation ``1e-6`` (``cos``/``sin`` differ by an ulp
between the libraries, as ``tests/test_torch_train.py`` holds it);
element-wise helpers ``rtol=1e-6``.
"""

import argparse
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gspn_tpu import ops as jops
from gspn_tpu.data import augment as jaugment
from gspn_tpu.data import iterator as jiterator
from gspn_tpu.models import gspn as jg
from gspn_tpu.models import pipeline as jpl
from gspn_tpu.models import rpointnet as jr
from gspn_tpu.nn import layers as jl
from gspn_tpu.ops import ball_group as jball_group
from gspn_tpu.train import config_io as jconfig_io
from gspn_tpu.train import train_gspn as jtrain_gspn
from gspn_tpu_torch import ops
from gspn_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gspn_tpu_torch.data import augment as taugment
from gspn_tpu_torch.data import iterator as titerator
from gspn_tpu_torch.data import native
from gspn_tpu_torch.models import gspn as tg
from gspn_tpu_torch.models import pipeline as tpl
from gspn_tpu_torch.models import rpointnet as tr
from gspn_tpu_torch.nn import layers as tl
from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.ops import ball_group as tball_group
from gspn_tpu_torch.ops import nms as tnms
from gspn_tpu_torch.train import checkpoint as tcheckpoint
from gspn_tpu_torch.train import config_io as tconfig_io
from gspn_tpu_torch.train import steps as tsteps
from gspn_tpu_torch.train import train_gspn as ttrain_gspn
from gspn_tpu_torch.utils import profiling
from tests.test_pipeline_eval import TINY
from tests.torch_parity import as_numpy_tree, n, pipeline_config, randomized, t

FWD = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# nn/layers.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("momentum,last", [(0.7, False), (0.95, True), (0.9, False)])
def test_point_mlp_momentum_and_last_activation_match_flax(rng, momentum, last):
    """``PointMLP(bn_momentum=, last_activation=)`` in training (output and
    the running statistics it leaves) and in eval mode against Flax's; a
    last layer without ReLU keeps negative outputs."""
    x = rng.normal(size=(3, 5, 7)).astype(np.float32)
    jm = jl.PointMLP((8, 4), bn_momentum=momentum, last_activation=last)
    v = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    y, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm = tl.PointMLP(7, (8, 4), bn_momentum=momentum, last_activation=last)
    tm.load_state_dict(flax_to_state_dict(as_numpy_tree(v)), strict=True)
    got = tm.train()(t(x))
    np.testing.assert_allclose(n(got), np.asarray(y), **FWD)
    assert (n(got) < 0).any() != last
    for k, w in flax_to_state_dict(as_numpy_tree({"batch_stats": mut["batch_stats"]})).items():
        np.testing.assert_allclose(n(tm.state_dict()[k]), n(w), **FWD, err_msg=k)
    jv = {"params": v["params"], "batch_stats": mut["batch_stats"]}
    np.testing.assert_allclose(n(tm.eval()(t(x))),
                               np.asarray(jm.apply(jv, jnp.asarray(x), train=False)), **FWD)


def test_fc_layers_with_batchnorm_match_flax(rng):
    """``FCLayers(use_bn=True)``: a BatchNorm after each hidden layer
    (``bn_<i>``, carried by ``convert.py`` both ways), in training and eval
    mode, with dropout's keep masks from Flax."""
    x = rng.normal(size=(6, 9)).astype(np.float32)
    jm = jl.FCLayers((8, 16), 5, use_bn=True, dropout=0.4)
    v = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    y, mut = jm.apply(v, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(3)},
                      capture_intermediates=True, mutable=["batch_stats", "intermediates"])
    keep = [t(np.asarray(mut["intermediates"][f"Dropout_{i}"]["__call__"][0]) != 0)
            for i in range(2)]
    tm = tl.FCLayers(9, (8, 16), 5, dropout=0.4, use_bn=True)
    sd = flax_to_state_dict(as_numpy_tree(v))
    assert {"bn_0.scale", "bn_1.mean"} <= set(sd)
    tm.load_state_dict(sd, strict=True)
    np.testing.assert_allclose(n(tm.train()(t(x), keep)), np.asarray(y), **FWD)
    for k, w in flax_to_state_dict(as_numpy_tree({"batch_stats": mut["batch_stats"]})).items():
        np.testing.assert_allclose(n(tm.state_dict()[k]), n(w), **FWD, err_msg=k)
    jv = {"params": v["params"], "batch_stats": mut["batch_stats"]}
    np.testing.assert_allclose(n(tm.eval()(t(x))),
                               np.asarray(jm.apply(jv, jnp.asarray(x), train=False)), **FWD)
    back = state_dict_to_flax(tm.state_dict())
    assert back["batch_stats"].keys() == {"bn_0", "bn_1"}


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def _boxes_and_cloud(rng):
    xyz = rng.uniform(0, 1, (2, 300, 3)).astype(np.float32)
    valid = rng.uniform(size=(2, 300)) > 0.2
    c = rng.uniform(0.2, 0.8, (2, 6, 3)).astype(np.float32)
    half = rng.uniform(0.02, 0.3, (2, 6, 1)).astype(np.float32)
    boxes = np.concatenate([c - half, c + half], -1)
    boxes[:, 5] = [3.0, 3.0, 3.0, 3.5, 3.5, 3.5]  # empty
    return xyz, valid, boxes


@pytest.mark.parametrize("select", ["first", "strided"])
def test_query_box_group_without_coords_matches_jax(rng, select):
    xyz, valid, boxes = _boxes_and_cloud(rng)
    want = jops.query_box_group(jnp.asarray(boxes), 16, jnp.asarray(xyz), jnp.asarray(valid),
                                with_coords=False, impl="xla", select=select)
    got = ops.query_box_group(t(boxes), 16, t(xyz), t(valid), with_coords=False, select=select)
    full = ops.query_box_group(t(boxes), 16, t(xyz), t(valid), select=select)
    assert len(got) == len(want) == 2
    for a, b, w in zip(got, full, want, strict=False):
        np.testing.assert_array_equal(n(a), np.asarray(w))
        assert torch.equal(a, b)


@pytest.mark.parametrize("select", ["first", "strided"])
def test_query_ball_multi_v2_matches_jax(rng, select):
    """The index-only drop-in: per scale JAX's ``(idx, cnt)`` and the port's
    ``query_ball_point_multi``'s."""
    xyz1 = rng.uniform(0, 1, (2, 400, 3)).astype(np.float32)
    xyz2 = xyz1[:, :20].copy()
    valid = rng.uniform(size=(2, 400)) > 0.25
    want = jball_group.query_ball_multi_v2((0.1, 0.25), (8, 24), jnp.asarray(xyz1),
                                           jnp.asarray(xyz2), jnp.asarray(valid), impl="xla",
                                           select=select)
    got = tball_group.query_ball_multi_v2((0.1, 0.25), (8, 24), t(xyz1), t(xyz2), t(valid),
                                          select=select)
    ref = ops.query_ball_point_multi((0.1, 0.25), (8, 24), t(xyz1), t(xyz2), t(valid),
                                     select=select)
    for (idx, cnt), (ri, rc), (wi, wc) in zip(got, ref, want, strict=True):
        np.testing.assert_array_equal(n(idx), np.asarray(wi))
        np.testing.assert_array_equal(n(cnt), np.asarray(wc))
        assert torch.equal(idx, ri) and torch.equal(cnt, rc)


def test_nms_box_limit_is_the_kernels():
    """The wrapper's ``MAX_R`` is ``nms.cu``'s ``kMaxR`` (131,072 boxes a
    scene, the suppressed bits in dynamic shared memory)."""
    m = re.search(r"constexpr int kMaxR = (\d+);", (_cuda.CSRC / "nms.cu").read_text())
    assert m and int(m.group(1)) == tnms.MAX_R == 131072


# ---------------------------------------------------------------------------
# data/augment.py
# ---------------------------------------------------------------------------

AUGMENT_OPTIONS = {
    "no_rotation": dict(rot_z=False),
    "no_flip": dict(flip=False),
    "no_scale": dict(scale_range=None),
    "wide_scale": dict(scale_range=(0.5, 2.0)),
    "jitter": dict(jitter_sigma=0.03, jitter_clip=0.02),
    "no_jitter": dict(jitter_sigma=0.0),
    "none": dict(rot_z=False, flip=False, scale_range=None, jitter_sigma=0.0),
}


@pytest.mark.parametrize("opts", list(AUGMENT_OPTIONS.values()), ids=list(AUGMENT_OPTIONS))
def test_augment_scene_options_match_jax(rng, opts):
    """Each of ``augment_scene``'s options against JAX's with its draws, and
    from a generator: every draw is taken in order (theta, flips, scale,
    noise) whatever is on, as JAX splits four keys, so turning a transform
    off leaves the others' draws alone."""
    xyz = rng.uniform(-1, 1, (3, 50, 3)).astype(np.float32)
    valid = rng.uniform(size=(3, 50)) > 0.2
    key = jax.random.PRNGKey(4)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    lo, hi = opts.get("scale_range") or (0.9, 1.1)
    draws = dict(theta=t(jax.random.uniform(k1, (3,), minval=0.0, maxval=2 * jnp.pi)),
                 scale=t(jax.random.uniform(k3, (3, 1, 1), minval=lo, maxval=hi)),
                 flips=t(jax.random.bernoulli(k2, 0.5, (3, 1, 2))),
                 noise=t(jax.random.normal(k4, (3, 50, 3))))
    want = jaugment.augment_scene(key, jnp.asarray(xyz), jnp.asarray(valid), **opts)
    got = taugment.augment_scene(t(xyz), t(valid), **{**opts, **draws})
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    if opts == AUGMENT_OPTIONS["none"]:
        np.testing.assert_array_equal(n(got), np.where(valid[..., None], xyz, 0.0))
    g = torch.Generator().manual_seed(7)
    drawn = dict(theta=torch.rand((3,), generator=g) * (2 * np.pi),
                 flips=torch.rand((3, 1, 2), generator=g) < 0.5,
                 scale=lo + torch.rand((3, 1, 1), generator=g) * (hi - lo),
                 noise=torch.randn((3, 50, 3), generator=g))
    a = taugment.augment_scene(t(xyz), t(valid), **opts,
                               generator=torch.Generator().manual_seed(7))
    b = taugment.augment_scene(t(xyz), t(valid), **opts, **drawn)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------


def test_load_config_reads_what_save_config_wrote(tmp_path):
    """The port's ``load_config`` reads the JAX package's file as JAX's
    ``load_config`` does, and its own."""
    jconfig_io.save_config(tmp_path / "j.json", model=jr.RPointNetConfig(remat=True))
    assert tconfig_io.load_config(tmp_path / "j.json") == jconfig_io.load_config(
        tmp_path / "j.json")
    tconfig_io.save_config(tmp_path / "t.json", model=tr.RPointNetConfig(remat=True),
                           args=argparse.Namespace(lr=0.5))
    got = tconfig_io.load_config(tmp_path / "t.json")
    assert got["args"] == {"lr": 0.5} and got["model"]["remat"] is True
    assert got == json.loads((tmp_path / "t.json").read_text())


@pytest.mark.parametrize("segments", [1, 8])
def test_shared_fps_indices_matches_jax(segments):
    """``shared_fps_indices`` is JAX's (one shared pass: the seeds a prefix
    of sa1's), and :func:`shared_fps_indices_view` without the view."""
    from gspn_tpu.models.presets import set_pipeline_fps_segments

    rng = np.random.default_rng(3)
    xyz = rng.uniform(0, 2, (2, 512, 3)).astype(np.float32)
    valid = np.ones((2, 512), bool)
    valid[:, 450:] = False
    jcfg = set_pipeline_fps_segments(dataclasses.replace(TINY), segments, "spatial")
    want = jpl.shared_fps_indices(jcfg, jnp.asarray(xyz), jnp.asarray(valid))
    cfg = pipeline_config(jcfg)
    got = tpl.shared_fps_indices(cfg, t(xyz), t(valid))
    view = tpl.shared_fps_indices_view(cfg, t(xyz), t(valid))
    for a, b, w in zip(got, view, want, strict=False):
        np.testing.assert_array_equal(n(a), np.asarray(w))
        assert torch.equal(a, b)
    assert torch.equal(got[0], got[1][:, :cfg.num_seeds])


def test_gather_roi_features_and_sigmoid_bce_match_jax(rng):
    feats = rng.normal(size=(2, 40, 5)).astype(np.float32)
    idx = rng.integers(0, 40, (2, 3, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        n(tr.gather_roi_features(t(feats), t(idx))),
        np.asarray(jr.gather_roi_features(jnp.asarray(feats), jnp.asarray(idx))))
    logits = rng.normal(0, 4, (50,)).astype(np.float32)
    logits[:2] = [60.0, -60.0]  # far into both tails
    labels = (rng.uniform(size=50) > 0.5).astype(np.float32)
    np.testing.assert_allclose(n(tg.optax_sigmoid_bce(t(logits), t(labels))),
                               np.asarray(jg.optax_sigmoid_bce(jnp.asarray(logits),
                                                               jnp.asarray(labels))),
                               rtol=1e-6, atol=1e-7)


def test_native_available():
    """The library builds and loads here (``g++`` is on the PATH), as
    ``impl="native"`` needs."""
    assert native.available() is True
    assert native.library() is not None


def _args(**kw):
    base = dict(dataset="synthetic", num_points=128, max_instances=3, extent=2.0,
                feature_dim=0, batch=2, preset="tiny", morton=False, scannet_dir=None,
                shapenet_dir=None, partnet_dir=None, synthetic_objects=False)
    return argparse.Namespace(**{**base, **kw})


def test_trainer_batch_helpers_match_jax():
    """``data_iterator`` draws the JAX trainer's batches from the same
    NumPy generator; ``device_batch`` stages one without ``scene_ids``."""
    args = ttrain_gspn.parse_args(["--device", "cpu", "--preset", "tiny", "--batch", "2",
                                   "--num-points", "128"])
    jargs = jtrain_gspn.parse_args(["--preset", "tiny", "--batch", "2", "--num-points", "128"])
    got = ttrain_gspn.data_iterator(args, np.random.default_rng(5))
    want = jtrain_gspn.data_iterator(jargs, np.random.default_rng(5))
    for _ in range(2):
        a, w = next(got), next(want)
        assert a.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(a[k], w[k], err_msg=k)
    staged = ttrain_gspn.device_batch(dict(a, scene_ids=["s0", "s1"]), "cpu")
    assert "scene_ids" not in staged and staged.keys() == a.keys()
    assert all(isinstance(v, torch.Tensor) for v in staged.values())
    assert torch.equal(staged["xyz"], torch.from_numpy(a["xyz"]))


def test_restore_or_init(tmp_path, capsys):
    """Fresh without ``resume`` or without a checkpoint; with one, the
    checkpoint's state and step, in place."""
    model = tl.PointMLP(3, (4,))
    state = tsteps.TrainState(model, tsteps.make_optimizer(model, 1e-3))
    ckpt = tcheckpoint.CheckpointManager(tmp_path / "ckpt")
    assert ttrain_gspn.restore_or_init(ckpt, state, False) == (state, 0)
    assert ttrain_gspn.restore_or_init(ckpt, state, True) == (state, 0)
    assert "no checkpoint found" in capsys.readouterr().out
    saved = {k: v.clone() + 1 for k, v in model.state_dict().items()}
    model.load_state_dict(saved)
    state.step = 7
    ckpt.save(state)
    other = tl.PointMLP(3, (4,))
    fresh = tsteps.TrainState(other, tsteps.make_optimizer(other, 1e-3))
    got, start = ttrain_gspn.restore_or_init(ckpt, fresh, True)
    assert got is fresh and start == 7 == fresh.step
    assert all(torch.equal(v, saved[k]) for k, v in other.state_dict().items())


def test_deterministic_batches_iterate_matches_jax():
    """``iterate(start_step)`` yields JAX's batches from that step on."""
    def sample(r, b):
        return {"x": r.normal(size=(b, 3)).astype(np.float32)}

    got = titerator.DeterministicBatches(sample, 2, seed=3).iterate(1)
    want = jiterator.DeterministicBatches(sample, 2, seed=3).iterate(1)
    for _ in range(3):
        np.testing.assert_array_equal(next(got)["x"], next(want)["x"])


def test_checkpoint_restore_params_at_a_step(tmp_path):
    """``restore_params`` reads the variables' entries of checkpoint
    ``step`` (the latest by default), None without a checkpoint, and names
    the entries a checkpoint lacks."""
    model = tl.PointMLP(3, (4,))
    state = tsteps.TrainState(model, tsteps.make_optimizer(model, 1e-3))
    ckpt = tcheckpoint.CheckpointManager(tmp_path / "ckpt")
    assert ckpt.restore_params(model) is None
    saved = {}
    for step in (1, 2):
        model.load_state_dict({k: v + step for k, v in model.state_dict().items()})
        state.step = step
        ckpt.save(state)
        saved[step] = {k: v.clone() for k, v in model.state_dict().items()}
    for step, got in ((1, ckpt.restore_params(model, step=1)), (2, ckpt.restore_params(model))):
        assert got.keys() == saved[step].keys()
        assert all(torch.equal(v, saved[step][k]) for k, v in got.items())
    with pytest.raises(KeyError, match="lacks"):
        ckpt.restore_params(tl.PointMLP(3, (4, 5)))


def test_profiling_trace_annotate_and_step_timer(tmp_path):
    """``trace`` writes a Chrome trace holding an ``annotate`` region;
    ``StepTimer`` keeps a window of host-clock steps on the CPU."""
    with profiling.trace(tmp_path / "prof") as prof:
        with profiling.annotate("gspn_region"):
            torch.ones(64).sum()
    assert any(e.name == "gspn_region" for e in prof.events())
    assert "gspn_region" in (tmp_path / "prof" / "trace.json").read_text()
    timer = profiling.StepTimer(1000, window=2)
    for _ in range(3):
        timer.start()
        torch.ones(64).sum()
        assert timer.stop() >= 0.0
    assert len(timer._times) == 2 and timer.points_per_sec > 0

