"""The knob paths in the port (``gspn_tpu_torch``) against the JAX package on
the CPU, at TINY shapes: bfloat16 MLP and head compute
(``presets.set_pipeline_dtype``, ``--dtype bf16``), per-point input
features (``feature_dim > 0``) and the single-object preset's config and
data (``gspn.shapenet_config``, ``synthetic.object_scene_batch``), through
inference, the exporter, the session and server, and the eval; and the
profiler windows' retake decision (``time_kernels.window_complete``). The
trainers on these knobs: ``tests/test_torch_knobs_train.py``.

Tolerances, and why:

- float32 with features: as the float32 tests (``tests/test_torch_pipeline.py``,
  ``tests/test_torch_train.py``): masks, valid and classes equal, scores and
  boxes within ``rtol=1e-4, atol=1e-5``, losses within ``1e-5``, gradients
  ``bench_slice.assert_grads_close``;
- bfloat16: XLA on the CPU fuses chains of bfloat16 operations and skips
  some of their roundings (where a product's sum is folded into a
  constant, for example), where the port rounds at each bfloat16 result,
  as a product's and a bias add's rounding on the card. So a value can
  differ by a bfloat16 step (2^-8 relative) anywhere downstream. The
  bounds on the pipeline's outputs: at most ``BF16_PROPOSAL_FLIPS`` of the
  proposals differ in validity or class (a class probability, an NMS IoU
  or a box edge at its threshold); scores of the proposals valid in both
  and every box within ``rtol=atol=2e-2`` (the frozen bf16 fixture's,
  ``tests/test_fixtures.py``); at most ``BF16_MASK_FLIPS`` of the mask
  cells differ (a logit at its threshold). Each stage's continuous
  outputs on the same inputs: within ``rtol=atol=2e-2``. The port sums a
  bfloat16 gather's gradient in float32 and rounds once, where JAX adds in
  bfloat16.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gspn_tpu import ops as jops
from gspn_tpu.data import synthetic as jsynthetic
from gspn_tpu.eval import instance_eval as jie
from gspn_tpu.eval import run_eval as jrun
from gspn_tpu.models import gspn as jg
from gspn_tpu.models import pipeline as jpl
from gspn_tpu.models import presets as jpresets
from gspn_tpu.models import rpointnet as jr
from gspn_tpu_torch import convert, ops
from gspn_tpu_torch.data import synthetic as tsynthetic
from gspn_tpu_torch.eval import run_eval
from gspn_tpu_torch.models import gspn as tg
from gspn_tpu_torch.models import pipeline as tpl
from gspn_tpu_torch.models import presets as tpresets
from gspn_tpu_torch.serve import export_serving
from gspn_tpu_torch.serve.export import load_artifact
from gspn_tpu_torch.serve.runtime import (
    Client, Server, chunk_noise, pipeline_config_from_manifest, session_from_checkpoints,
)
from gspn_tpu_torch.train import train_gspn as ttrain_gspn
from gspn_tpu_torch.utils import time_kernels as tk
from tests.test_fixtures import _base_pipeline_variables, _load
from tests.test_pipeline_eval import TINY
from tests.torch_parity import as_numpy_tree, gspn_config, n, pipeline_config, randomized, t

PARITY = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
BF16_PROPOSAL_FLIPS = 1 / 16  # share of proposals
BF16_MASK_FLIPS = 0.01  # share of mask cells
FDIM = 3  # RGB
B, NPTS = 2, 192  # scenes, points a scene


def _scenes(seed=0, feature_dim=FDIM, b=B, npts=NPTS):
    return jsynthetic.scene_batch(np.random.default_rng(seed), b, n_points=npts,
                                  max_instances=3, extent=2.0, feature_dim=feature_dim)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _with_features(jcfg, fdim=FDIM):
    return dataclasses.replace(jcfg, gspn=dataclasses.replace(jcfg.gspn, feature_dim=fdim),
                               rpointnet=dataclasses.replace(jcfg.rpointnet, feature_dim=fdim))


def _port_model(cfg, variables):
    model = tpl.PipelineModel(cfg)
    model.load_state_dict(convert.pipeline_state_dict(as_numpy_tree(variables)), strict=True)
    return model.eval()


def _prior_noise(jcfg, b, key=1):
    """The CVAE noise the JAX ``infer`` draws from ``PRNGKey(key)``."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(key),
                                        (b, jcfg.num_seeds, jcfg.gspn.latent_dim), jnp.float32))


def _close(a, b):
    """Elementwise ``np.isclose`` at the bfloat16 bounds, all over the last
    axis."""
    return np.isclose(a, b, **BF16).reshape(*a.shape[:2], -1).all(-1)


def _assert_bf16_preds(got, want):
    """The bfloat16 bounds of the module docstring: a proposal flips where
    its validity or class differs or its score or box leaves the bounds
    (RoI samples taken or NMS decided on the other side of a box edge);
    returns ``(proposals that flipped, share of mask cells that differ)``."""
    gv, wv = n(got.valid), np.asarray(want.valid)
    same = (gv == wv) & (~gv | (n(got.classes) == np.asarray(want.classes)))
    same &= _close(n(got.scores)[..., None], np.asarray(want.scores)[..., None])
    same &= _close(n(got.boxes), np.asarray(want.boxes))
    assert (~same).mean() <= BF16_PROPOSAL_FLIPS, (~same).sum()
    masks = float((n(got.masks) != np.asarray(want.masks)).mean())
    assert masks <= BF16_MASK_FLIPS, masks
    return int((~same).sum()), masks


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------


def test_set_pipeline_dtype_matches_jax():
    """``set_pipeline_dtype`` and ``scannet_pipeline(dtype=...)``: both stages
    switched, everything else as it was, as in the JAX package."""
    want = pipeline_config(jpresets.set_pipeline_dtype(TINY, jnp.bfloat16))
    got = tpresets.set_pipeline_dtype(pipeline_config(TINY), torch.bfloat16)
    assert got == want and got.gspn.dtype == got.rpointnet.dtype == torch.bfloat16
    assert tpresets.scannet_pipeline(dtype=torch.bfloat16, feature_dim=FDIM) == pipeline_config(
        jpresets.scannet_pipeline(dtype=jnp.bfloat16, feature_dim=FDIM))
    with pytest.raises(ValueError, match="dtype"):
        tpl.make_inference_fn(tpresets.set_pipeline_dtype(pipeline_config(TINY), torch.float16))


@pytest.mark.parametrize("args", [(), (4096, 512), (64, 32)], ids=str)
def test_shapenet_config_matches_jax(args):
    got, want = tg.shapenet_config(*args), gspn_config(jg.shapenet_config(*args))
    assert got == want
    assert got.context_radii == (2.0,) and got.context_nsample == (args or (1024,))[:1]


@pytest.mark.parametrize("kind", [None, "box", "sphere", "cylinder"])
def test_object_batches_match_jax(kind):
    """``object_batch`` and ``object_scene_batch``: the JAX package's arrays
    and dtypes, bit for bit, from the same NumPy generator."""
    a = tsynthetic.object_scene_batch(np.random.default_rng(2), 3, 96, kind)
    b = jsynthetic.object_scene_batch(np.random.default_rng(2), 3, 96, kind)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], k)
    pa, ka = tsynthetic.object_batch(np.random.default_rng(3), 2, 40, kind)
    pb, kb = jsynthetic.object_batch(np.random.default_rng(3), 2, 40, kind)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(ka, kb)
    assert ka.dtype == np.int32 and (a["inst_label"] == 1).all() and a["valid"].all()


def test_feature_variables_convert_and_stay_float32():
    """The JAX pipeline's variables at ``feature_dim=3`` in bfloat16 load
    strictly into the port's model: the first layers of the crops'
    encoders and of SA1 widened by the feature width, every parameter and
    statistic float32 (the converter needs nothing new)."""
    jcfg = jpresets.set_pipeline_dtype(_with_features(TINY), jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jpl.init_pipeline_variables(
        jcfg, jax.random.PRNGKey(0), 64, feature_dim=FDIM))
    assert all(x.dtype == jnp.float32 for x in jax.tree_util.tree_leaves(shapes))
    jv = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32), shapes)
    cfg = pipeline_config(jcfg)
    model = _port_model(cfg, jv)
    sd = model.state_dict()
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert sd["gspn.center_enc.mlp.dense_0.weight"].shape[1] == 3 + FDIM
    assert sd["gspn.ctx_enc_1.mlp.dense_0.weight"].shape[1] == 3 + FDIM
    assert sd["rpointnet.backbone.sa1.mlp.dense_0.weight"].shape[1] == 3 + FDIM
    seeded = tpl.init_pipeline_variables(cfg, torch.Generator().manual_seed(0), 64, FDIM)
    assert {k: v.shape for k, v in seeded.items()} == {k: v.shape for k, v in sd.items()}
    with pytest.raises(ValueError, match="feature_dim"):
        tpl.init_pipeline_variables(cfg, torch.Generator().manual_seed(0), 64, feature_dim=0)


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["exact_0.47", "exact_0.45", "grid_0.455", "spatial_0.47"])
def test_bf16_inference_matches_jax(case):
    """``set_pipeline_dtype(TINY, bf16)`` on the frozen fixture's weights and
    scenes with the noise JAX draws, at mask thresholds inside the range of
    the mask logits, against the JAX package's ``make_inference_fn``."""
    mode, thresh = case.split("_")
    jcfg = dataclasses.replace(jpresets.set_pipeline_dtype(TINY, jnp.bfloat16),
                               mask_thresh=float(thresh))
    if mode == "grid":
        jcfg = dataclasses.replace(jcfg, rpointnet=dataclasses.replace(jcfg.rpointnet,
                                                                       roi_sample="grid"))
    elif mode == "spatial":
        jcfg = jpresets.set_pipeline_fps_segments(dataclasses.replace(jcfg, num_seeds=16), 2,
                                                  "spatial")
    z = _load("instance_inference.npz")
    xyz, valid, variables = z["in/xyz"], z["in/valid"], _base_pipeline_variables(z)
    want = jpl.make_inference_fn(jcfg)(variables, jnp.asarray(xyz), None, jnp.asarray(valid),
                                       jax.random.PRNGKey(1))
    cfg = pipeline_config(jcfg)
    with torch.inference_mode():
        got = tpl.make_inference_fn(cfg)(_port_model(cfg, variables), t(xyz), t(valid),
                                         z_eps=t(_prior_noise(jcfg, xyz.shape[0])))
    _assert_bf16_preds(got, want)
    m = n(got.masks)[n(got.valid)]
    assert m.any() and not m.all()
    assert got.scores.dtype == got.boxes.dtype == torch.float32


FEATURE_CASES = {
    "exact_fps": lambda c: c,
    "spatial_fps": lambda c: jpresets.set_pipeline_fps_segments(
        dataclasses.replace(c, num_seeds=16), 2, "spatial"),
    "grid_roi": lambda c: dataclasses.replace(
        c, rpointnet=dataclasses.replace(c.rpointnet, roi_sample="grid")),
    "strided_select": lambda c: jpresets.set_pipeline_group_select(c, "strided"),
}


@functools.lru_cache(maxsize=None)
def _feature_world(seed=3, std=0.15):
    """Randomized JAX variables of ``TINY`` at ``feature_dim=3`` and scenes
    with RGB features from the JAX package's generator."""
    jcfg = _with_features(TINY)
    jv = randomized(jpl.init_pipeline_variables(jcfg, jax.random.PRNGKey(0), NPTS,
                                                feature_dim=FDIM), seed, std)
    return jv, _scenes(5)


@pytest.mark.parametrize("case", sorted(FEATURE_CASES))
def test_feature_inference_matches_jax(case):
    """``feature_dim=3``: the crops and SA1 group the RGB features; the port
    against the JAX ``make_inference_fn`` on the same weights, scenes,
    features and noise."""
    jv, sb = _feature_world()
    jcfg = FEATURE_CASES[case](_with_features(TINY))
    want = jpl.make_inference_fn(jcfg)(jv, jnp.asarray(sb["xyz"]), jnp.asarray(sb["features"]),
                                       jnp.asarray(sb["valid"]), jax.random.PRNGKey(1))
    cfg = pipeline_config(jcfg)
    with torch.inference_mode():
        got = tpl.make_inference_fn(cfg)(
            _port_model(cfg, jv), t(sb["xyz"]), t(sb["valid"]),
            z_eps=t(_prior_noise(jcfg, B)), features=t(sb["features"]))
    for f in ("masks", "valid", "classes"):
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(want, f)), f)
    for f in ("scores", "boxes"):
        np.testing.assert_allclose(n(getattr(got, f)), np.asarray(getattr(want, f)), **PARITY,
                                   err_msg=f)
    m = n(got.masks)[n(got.valid)]
    assert m.any() and not m.all()
    # the features are read: other features give other outputs
    with torch.inference_mode():
        other = tpl.make_inference_fn(cfg)(
            _port_model(cfg, jv), t(sb["xyz"]), t(sb["valid"]),
            z_eps=t(_prior_noise(jcfg, B)), features=t(sb["features"][:, ::-1].copy()))
    assert not torch.equal(other.scores, got.scores)
    with pytest.raises(ValueError, match="pass features"):
        tpl.make_inference_fn(cfg)(_port_model(cfg, jv), t(sb["xyz"]), t(sb["valid"]),
                                   z_eps=t(_prior_noise(jcfg, B)))


def test_bf16_feature_stages_match_jax():
    """Both knobs at once, each stage on the same inputs: the GSPN's
    outputs (bfloat16 crops with RGB), then R-PointNet's heads on the JAX
    GSPN's proposal boxes (bfloat16 backbone over RGB), in eval mode, within
    the bfloat16 bounds; the float32 outputs come out float32."""
    jv, sb = _feature_world()
    jcfg = jpresets.set_pipeline_dtype(_with_features(TINY), jnp.bfloat16)
    xyz, feats, valid = (jnp.asarray(sb[k]) for k in ("xyz", "features", "valid"))
    seeds = jops.farthest_point_sample(jcfg.num_seeds, xyz, valid, impl="xla")
    eps = _prior_noise(jcfg, B)
    jo = jg.GSPN(jcfg.gspn).apply(jv["gspn"], xyz, seeds, features=feats, valid=valid,
                                  z_eps=jnp.asarray(eps))
    boxes = jg.proposal_boxes(jo.generated, jcfg.rpointnet.box_margin)
    jr_out = jr.RPointNet(jcfg.rpointnet).apply(jv["rpointnet"], xyz, boxes, features=feats,
                                                valid=valid)
    cfg = pipeline_config(jcfg)
    model = _port_model(cfg, jv)
    with torch.inference_mode():
        to = model.gspn(t(sb["xyz"]), t(np.asarray(seeds)), t(sb["valid"]), z_eps=t(eps),
                        features=t(sb["features"]))
        ro = model.rpointnet(t(sb["xyz"]), t(np.asarray(boxes)), t(sb["valid"]),
                             features=t(sb["features"]))
    for f in ("center", "generated", "objectness", "prior_mu", "prior_logvar"):
        assert getattr(to, f).dtype == torch.float32, f
        np.testing.assert_allclose(n(getattr(to, f)), np.asarray(getattr(jo, f)), **BF16,
                                   err_msg=f)
    assert to.cond.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(ro.roi_valid), np.asarray(jr_out.roi_valid))
    np.testing.assert_array_equal(n(ro.roi_idx), np.asarray(jr_out.roi_idx))
    for f in ("cls_logits", "box_deltas", "mask_logits"):
        assert getattr(ro, f).dtype == torch.float32, f
        np.testing.assert_allclose(n(getattr(ro, f)), np.asarray(getattr(jr_out, f)), **BF16,
                                   err_msg=f)


# ---------------------------------------------------------------------------
# the gather's bfloat16 gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_gather_bf16_gradient_sums_in_float32(impl):
    """A bfloat16 gather's backward: the float32 sums of ``index_add_rows``
    (in ascending position) rounded once to bfloat16; the float32 gather's
    gradient is untouched."""
    rng = np.random.default_rng(0)
    idx = t(rng.integers(0, 10, (2, 64)).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(2, 64, 5)).astype(np.float32)).bfloat16()
    x = torch.zeros((2, 10, 5), dtype=torch.bfloat16, requires_grad=True)
    ops.gather_point(x, idx, impl=impl).backward(g)
    want = ops.index_add_rows(g.float(), idx, 10, impl="plain").bfloat16()
    assert x.grad.dtype == torch.bfloat16 and torch.equal(x.grad, want)
    x32 = torch.zeros((2, 10, 5), requires_grad=True)
    ops.gather_point(x32, idx, impl=impl).backward(g.float())
    assert torch.equal(x32.grad, ops.index_add_rows(g.float(), idx, 10, impl="plain"))


# ---------------------------------------------------------------------------
# serving and the eval
# ---------------------------------------------------------------------------


def test_bf16_feature_export_session_and_client(tmp_path):
    """``export_serving --dtype bf16 --feature-dim 3 --verify`` on the CPU:
    the manifest carries both; ``InferenceSession`` takes the features and
    checks their shape (the JAX session's errors); ``predict`` equals the
    live pipeline with the chunk's noise; a ``Client`` round trip through a
    ``Server`` equals ``predict``."""
    out = tmp_path / "bf.gspnt"
    args = ["--device", "cpu", "--preset", "tiny", "--batch", "2", "--num-points", "128",
            "--num-seeds", "8", "--num-classes", "3", "--score-thresh", "0", "--dtype", "bf16",
            "--feature-dim", str(FDIM)]
    export_serving.main(args + ["--out", str(out), "--verify"])
    _, manifest = load_artifact(out, "cpu")
    cfg = pipeline_config_from_manifest(manifest)
    assert manifest["inputs"]["features"] == [2, 128, FDIM]
    assert cfg.gspn.dtype == cfg.rpointnet.dtype == torch.bfloat16
    assert cfg.gspn.feature_dim == cfg.rpointnet.feature_dim == FDIM
    session = session_from_checkpoints(out, device="cpu")
    sb = _scenes(4, npts=128, b=3)
    got = session.predict(sb["xyz"], sb["valid"], sb["features"], seed=2)
    assert got["masks"].shape == (3, 8, 128)
    model = tpl.PipelineModel(cfg)
    model.load_state_dict(session.state)
    infer = tpl.make_inference_fn(cfg)
    with torch.inference_mode():
        live = infer(model.eval(), t(sb["xyz"][:2]), t(sb["valid"][:2]),
                     z_eps=chunk_noise(2, 0, session.noise_shape), features=t(sb["features"][:2]))
    for f in tpl.PREDICTION_FIELDS:
        np.testing.assert_array_equal(got[f][:2], n(getattr(live, f)), f)
    with pytest.raises(ValueError, match="expects features"):
        session.predict(sb["xyz"], sb["valid"])
    with pytest.raises(ValueError, match="features must be"):
        session.predict(sb["xyz"], sb["valid"], sb["features"][..., :2])
    sock = tmp_path / "s.sock"
    with Server(session, str(sock)):
        with Client(str(sock)) as client:
            remote = client.predict(sb["xyz"], sb["valid"], sb["features"], seed=2)
            with pytest.raises(RuntimeError, match="expects features"):
                client.predict(sb["xyz"], sb["valid"], seed=2)
    for f in tpl.PREDICTION_FIELDS:
        np.testing.assert_array_equal(remote[f], got[f], f)
    f32 = tmp_path / "f32.gspnt"
    export_serving.main(args[:-4] + ["--out", str(f32)])
    plain = session_from_checkpoints(f32, device="cpu")
    with pytest.raises(ValueError, match="without features"):
        plain.predict(sb["xyz"], sb["valid"], sb["features"])


@pytest.fixture(scope="module")
def jax_bf16_eval():
    """The JAX eval's ``main --dtype bf16`` on TINY scenes, its weights
    randomized: its variables and each batch's raw predictions."""
    from tests.test_torch_eval import PARITY as EVAL_ARGS
    from tests.test_torch_eval import WEIGHTS_SEED, WEIGHTS_STD, _summary

    real_init, real_pfd = jrun.init_pipeline_variables, jie.predictions_from_device
    taken, recorded = {}, []

    def init(cfg, key, n_pts, feature_dim=0):
        taken["variables"] = randomized(real_init(cfg, key, n_pts, feature_dim=feature_dim),
                                        WEIGHTS_SEED, WEIGHTS_STD)
        return taken["variables"]

    def record(preds, scene_valid=None):
        recorded.append(preds)
        return real_pfd(preds, scene_valid)

    argv = EVAL_ARGS[:EVAL_ARGS.index("--ab-sa1-fps-segments")] + ["--dtype", "bf16"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrun, "init_pipeline_variables", init)
        mp.setattr(jie, "predictions_from_device", record)
        _summary(jrun.main, argv)
    return argv, taken["variables"], recorded


def test_bf16_eval_loop_matches_jax(jax_bf16_eval):
    """``run_eval --dtype bf16``'s config is the JAX eval's, and its loop
    (``evaluate`` over ``live_infer``) on the JAX eval's weights, batches
    and noise gives each batch's predictions within the bf16 bounds."""
    argv, variables, recorded = jax_bf16_eval
    args = run_eval.parse_args(argv + ["--device", "cpu"])
    cfg = run_eval.build_config(args)
    assert cfg.gspn.dtype == cfg.rpointnet.dtype == torch.bfloat16
    state = convert.pipeline_state_dict(as_numpy_tree(variables))
    eps = jax.random.normal(jax.random.PRNGKey(args.seed),
                            (args.batch, cfg.num_seeds, cfg.gspn.latent_dim), jnp.float32)
    outs = []
    infer = run_eval.live_infer(cfg, state, "cpu")

    def call(xyz, valid, z_eps):
        preds = infer(xyz, valid, z_eps)
        outs.append(preds)
        return preds

    run_eval.evaluate(call, run_eval.scene_batches(args)(), t(eps))
    assert len(outs) == len(recorded) == 2
    for got, want in zip(outs, recorded, strict=True):
        _assert_bf16_preds(got, want)


def test_eval_reads_the_data_features(tmp_path, monkeypatch):
    """The eval with data that carries RGB: ``main`` widens both stages to
    the data's feature width, its loop hands each batch's features to the
    pipeline (the same predictions as calling it with them), and a
    checkpoint trained without features is refused."""
    from tests.test_torch_eval import TINY as EVAL_TINY

    ttrain_gspn.main(["--device", "cpu", "--preset", "tiny", "--steps", "1", "--batch", "2",
                      "--num-points", "128", "--num-seeds", "8", "--gt-size", "16",
                      "--log-dir", str(tmp_path / "g")])  # without features
    real = tsynthetic.scene_batch
    monkeypatch.setattr(run_eval.synthetic, "scene_batch",
                        lambda rng, b, **kw: real(rng, b, feature_dim=FDIM, **kw))
    args = run_eval.parse_args(EVAL_TINY + ["--device", "cpu"])
    cfg = run_eval.with_feature_dim(run_eval.build_config(args), FDIM)
    state = tpl.init_pipeline_variables(cfg, torch.Generator().manual_seed(0), 192)
    eps = chunk_noise(0, 0, (args.batch, cfg.num_seeds, cfg.gspn.latent_dim))
    seen = []
    infer = run_eval.live_infer(cfg, state, "cpu")

    def call(xyz, valid, z_eps, features=None):
        seen.append(features)
        return infer(xyz, valid, z_eps, features=features)

    run = run_eval.evaluate(call, run_eval.scene_batches(args)(), eps)
    assert len(seen) == 2 and all(f is not None and f.shape[-1] == FDIM for f in seen)
    first = next(iter(run_eval.scene_batches(args)()))
    with torch.inference_mode():
        direct = infer(t(first["xyz"]), t(first["valid"]), eps, features=t(first["features"]))
    want = run_eval.ie.predictions_from_device(direct, first["valid"])
    for got, w in zip(run.preds[:2], want, strict=True):
        np.testing.assert_array_equal(got.masks, w.masks)
        np.testing.assert_array_equal(got.scores, w.scores)
    res = run_eval.main(EVAL_TINY + ["--device", "cpu"])
    assert {"ap", "per_class"} <= set(res)
    with pytest.raises(ValueError, match="feature_dim=0"):
        run_eval.main(EVAL_TINY + ["--device", "cpu", "--gspn-ckpt", str(tmp_path / "g" / "ckpt")])


# ---------------------------------------------------------------------------
# the profiler windows' retake decision (time_kernels.window_complete)
# ---------------------------------------------------------------------------

SPIN, K = "void at::native::spin_kernel(long)", "void index_add_kernel(float const*, ...)"
OTHER = "void at::native::vectorized_elementwise_kernel<4, ...>"


@pytest.mark.parametrize("names,launched,complete", [
    ([SPIN, K, OTHER, K, OTHER, K, SPIN], 3, True),
    ([K, OTHER, K, OTHER, K, SPIN], 3, True),  # the opening spin's record lost: its role
    ([SPIN, OTHER, K, OTHER, K, SPIN], 3, False),  # the first kernel's record lost
    ([SPIN, K, OTHER, OTHER, K, SPIN], 3, False),  # a middle record lost
    ([SPIN, K, OTHER, K, OTHER, SPIN], 3, False),  # the last kernel's record lost
    ([SPIN, K, OTHER, K, OTHER, K], 3, False),  # the closing spin lost
    ([SPIN, K, K, K, SPIN], 0, True),  # a graph replay: the counter saw no launch
    ([], 0, False),  # a whole window lost
], ids=["complete", "opening_spin_lost", "first_lost", "middle_lost", "last_lost",
        "closing_spin_lost", "graph_replay", "window_lost"])
def test_window_complete_retakes_windows_that_lost_records(names, launched, complete):
    assert tk.window_complete(names, launched) is complete
    assert tk.kernel_event(K) and not tk.kernel_event(OTHER) and not tk.kernel_event(SPIN)
