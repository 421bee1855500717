"""Training on the knob paths in the port (``gspn_tpu_torch``) against the
JAX package on the CPU, at the trainers' TINY widths: the stage-1 and
stage-2 losses and gradients with per-point RGB features (``feature_dim=3``)
and in bfloat16, one bfloat16 step of each trainer against ``optax.adam``,
the single-object preset (``train_gspn --preset object
--synthetic-objects``) and the trainers' entry points with those flags.

Tolerances, and why:

- float32: as ``tests/test_torch_train.py``: losses and terms within
  ``rtol=atol=1e-5``, gradients ``bench_slice.assert_grads_close``; after
  an Adam step every parameter within ``2 * lr`` (a gradient element near
  0 can take either sign from rounding, and Adam moves it by up to
  ``lr``), since the gradients themselves are held first;
- bfloat16: losses and terms within ``rtol=2e-2, atol=1e-3``. Gradients:
  the parameters after the max pools (the FC heads) within ``BF16_GRAD``
  of their norm; the Dense biases that feed a training-mode BatchNorm
  (true gradient 0) within ``BF16_GRAD`` of their layer's largest weight
  gradient; the layers before a max pool (encoders, backbone, RoI MLP) in
  direction, a cosine of at least ``BF16_COSINE``: bfloat16 activations
  tie at a max far more often than float32 ones, a one-step difference
  between the frameworks moves which points tie, and both split a max's
  gradient among its ties. After one Adam step every parameter within
  ``2 * lr``.
"""

import dataclasses
import json
import re

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
from gspn_tpu.models import rpointnet as jr
from gspn_tpu.train import steps as jsteps
from gspn_tpu.train import train_gspn as jtrain_gspn
from gspn_tpu.train import train_rpointnet as jtrain_rp
from gspn_tpu_torch import convert
from gspn_tpu_torch.data import iterator as titerator
from gspn_tpu_torch.models import gspn as tg
from gspn_tpu_torch.models import rpointnet as tr
from gspn_tpu_torch.train import steps as tsteps
from gspn_tpu_torch.train import train_gspn as ttrain_gspn
from gspn_tpu_torch.train import train_rpointnet as ttrain_rp
from gspn_tpu_torch.utils import bench_slice
from tests.test_torch_train import _perturbed
from tests.torch_parity import as_numpy_tree, gspn_config, n, rpointnet_config, t

FWD = dict(rtol=1e-5, atol=1e-5)
BF16_LOSS = dict(rtol=2e-2, atol=1e-3)
BF16_GRAD = 1e-1  # norm-wise (the TINY GSPN's heads with RGB: 0.4-7 %)
BF16_COSINE = 0.95
FDIM = 3  # RGB
B, S, G, I = 2, 8, 16, 4  # scenes, seeds, GT points a seed, GT instances at most
LR = 1e-3
# the parameters before a max pool (the heads' FC layers come after one)
BEFORE_POOL = re.compile(r"(_enc(_\d+)?\.|^backbone\.|^heads\.roi_mlp\.|^heads\.mask_mlp\.)")


def _scenes(seed=0, feature_dim=FDIM, npts=256):
    return jsynthetic.scene_batch(np.random.default_rng(seed), B, n_points=npts,
                                  max_instances=3, extent=2.0, feature_dim=feature_dim)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grads(jgrads):
    return convert.flax_to_state_dict(as_numpy_tree({"params": jgrads}))


def _assert_bf16_grads(got, want):
    for name, w in want.items():
        g = got[name].float()
        if bench_slice._BN_FED_BIAS.search(name):
            scale = want[name[: -len("bias")] + "weight"].abs().max().item()
            assert (g - w).abs().max().item() <= BF16_GRAD * scale, name
        elif BEFORE_POOL.search(name):
            cos = torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0).item()
            assert cos >= BF16_COSINE, (name, cos)
        else:
            err, ref = (g - w).norm().item(), w.norm().item()
            assert err <= BF16_GRAD * ref + 1e-6, (name, err, ref)


def _assert_after_adam(want, got):
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(n(got[k]), n(w), rtol=1e-4, atol=2 * LR, err_msg=k)


# ---------------------------------------------------------------------------
# stage 1
# ---------------------------------------------------------------------------


def _gspn_world(jcfg, batch, seeds=S, gt=G, seed=11):
    """JAX GSPN training variables (near their init, ``_perturbed``)."""
    jb = _jbatch(batch)
    jm = jg.GSPN(jcfg)
    idx = jops.farthest_point_sample(seeds, jb["xyz"], jb["valid"], impl="xla")
    gp, gv, _, _ = jinstances.gather_seed_instances(jb["xyz"], jb["inst_label"], idx, gt)
    key = jax.random.PRNGKey(0)
    feats = jb["features"] if jcfg.feature_dim else None
    v = jm.init(key, jb["xyz"], idx, features=feats, valid=jb["valid"], gt_points=gp,
                gt_valid=gv, z_rng=key, train=False)
    return jm, _perturbed(v, seed)


def _port_gspn(jcfg, v):
    m = tg.GSPN(gspn_config(jcfg), recognition=True)
    m.load_state_dict(convert.flax_to_state_dict(as_numpy_tree(v)), strict=True)
    return m.train()


def _z_eps(rng, latent, s=S):
    """The CVAE noise ``make_gspn_loss_fn`` draws from ``rng``."""
    return t(jax.random.normal(jax.random.split(rng)[1], (B, s, latent), jnp.float32))


def _gspn_loss_and_grads(jcfg, batch, seeds=S, gt=G):
    """The JAX loss's value and gradients, and the port's on the same
    variables, batch and noise: ``(jmetrics, jgrads, metrics, grads,
    JAX variables)``."""
    jm, v = _gspn_world(jcfg, batch, seeds, gt)
    rng = jax.random.PRNGKey(21)
    (_, (jmetrics, _)), jgrads = jax.jit(jax.value_and_grad(
        jsteps.make_gspn_loss_fn(jm, seeds, gt), has_aux=True))(
        v["params"], v["batch_stats"], _jbatch(batch), rng)
    tm = _port_gspn(jcfg, v)
    total, metrics = tsteps.make_gspn_loss_fn(seeds, gt)(
        tm, titerator.to_device(batch, "cpu"), z_eps=_z_eps(rng, jcfg.latent_dim, seeds))
    total.backward()
    grads = {k: p.grad for k, p in tm.named_parameters()}
    assert grads.keys() == _grads(jgrads).keys()
    return jmetrics, _grads(jgrads), metrics, grads, (jm, v)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_feature_gspn_loss_and_gradients_match_jax(dtype):
    """The stage-1 loss (FPS seeds, GT pairing, the training forward over
    crops with RGB features, ``gspn_loss``), its terms and every gradient
    against ``jax.value_and_grad`` of ``make_gspn_loss_fn``."""
    jcfg = dataclasses.replace(jtrain_gspn.TINY_GSPN, ops_impl="xla", feature_dim=FDIM,
                               dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    jmetrics, want, metrics, got, _ = _gspn_loss_and_grads(jcfg, _scenes(0))
    tol = FWD if dtype == "f32" else BF16_LOSS
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), **tol,
                                   err_msg=k)
    assert all(g.dtype == torch.float32 for g in got.values())
    if dtype == "f32":
        bench_slice.assert_grads_close(got, want)
    else:
        _assert_bf16_grads(got, want)
    w = "center_enc.mlp.dense_0.weight"
    assert got[w].shape[1] == 3 + FDIM and got[w][:, 3:].abs().sum() > 0  # the RGB columns


def _one_adam_step(jloss, jv, port_model, port_loss, batch, draws):
    """One step of ``optax.adam(LR)`` on the JAX side and of the port's
    ``make_train_step`` from the same variables: ``(jax metrics, port
    metrics, jax state dict after, port state dict after)``."""
    tx = optax.adam(LR)
    state = jsteps.TrainState.create(jv, tx)
    state, jmetrics = jsteps.make_train_step(jloss, tx)(state, _jbatch(batch),
                                                       jax.random.PRNGKey(100))
    tstate = tsteps.TrainState(port_model, tsteps.make_optimizer(port_model, LR))
    metrics = tsteps.make_train_step(port_loss, lambda i: LR)(
        tstate, titerator.to_device(batch, "cpu"), **draws)
    want = convert.flax_to_state_dict(as_numpy_tree({"params": state.params,
                                                     "batch_stats": state.batch_stats}))
    return jmetrics, metrics, want, port_model.state_dict()


def test_bf16_gspn_train_step_matches_optax():
    """One bfloat16 stage-1 step (``train_gspn --dtype bf16``'s model and
    loss) against the JAX step with ``optax.adam``."""
    jcfg = dataclasses.replace(jtrain_gspn.TINY_GSPN, ops_impl="xla", dtype=jnp.bfloat16)
    batch = _scenes(0, feature_dim=0)
    jm, v = _gspn_world(jcfg, batch)
    jmetrics, metrics, want, got = _one_adam_step(
        jsteps.make_gspn_loss_fn(jm, S, G), v, _port_gspn(jcfg, v), tsteps.make_gspn_loss_fn(S, G),
        batch, {"z_eps": _z_eps(jax.random.PRNGKey(100), jcfg.latent_dim)})
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), **BF16_LOSS, err_msg=k)
    _assert_after_adam(want, got)


OBJECT_ARGS = ["--preset", "object", "--synthetic-objects", "--num-points", "64",
               "--num-seeds", "4", "--gt-size", "32", "--batch", "2"]


def test_object_preset_matches_jax():
    """``train_gspn --preset object --synthetic-objects``: the port's trainer
    builds the JAX trainer's config (``shapenet_config(64, 512)``: one crop
    of radius 2 holding all 64 points) and batches; on that model and batch
    the loss, its terms and every gradient equal the JAX package's, and one
    step the JAX step with ``optax.adam``."""
    args, jargs = ttrain_gspn.parse_args(OBJECT_ARGS), jtrain_gspn.parse_args(OBJECT_ARGS)
    tb = titerator.DeterministicBatches(ttrain_gspn.make_sample_fn(args), 2, 0).batch_at(0)
    jb = jtrain_gspn.DeterministicBatches(jtrain_gspn.make_sample_fn(jargs), 2, 0).batch_at(0)
    assert tb.keys() == jb.keys() and all(np.array_equal(tb[k], jb[k]) for k in tb)
    cfg = ttrain_gspn.model_config(args, tb)
    assert cfg == gspn_config(jg.shapenet_config(64, num_gen_points=512))
    jcfg = dataclasses.replace(jg.shapenet_config(64, num_gen_points=512), ops_impl="xla")
    jmetrics, want, metrics, got, (jm, v) = _gspn_loss_and_grads(jcfg, tb, seeds=4, gt=32)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), **FWD,
                                   err_msg=k)
    bench_slice.assert_grads_close(got, want)
    _, step_metrics, after, port_after = _one_adam_step(
        jsteps.make_gspn_loss_fn(jm, 4, 32), v, _port_gspn(jcfg, v),
        tsteps.make_gspn_loss_fn(4, 32), tb,
        {"z_eps": _z_eps(jax.random.PRNGKey(100), jcfg.latent_dim, s=4)})
    assert np.isfinite(float(step_metrics["loss"]))
    _assert_after_adam(after, port_after)


def test_train_gspn_object_preset_and_bf16_run_on_the_cpu(tmp_path):
    """The trainer's entry point with ``--preset object --synthetic-objects``
    and with ``--dtype bf16``: finite losses, the config saved beside the
    checkpoint with its crop and dtype, parameters float32."""
    common = ["--device", "cpu", "--steps", "2", "--log-every", "1"]
    obj = ttrain_gspn.main(common + OBJECT_ARGS + ["--log-dir", str(tmp_path / "o")])
    assert obj.model.config.context_nsample == (64,) and obj.model.config.num_gen_points == 512
    bf = ttrain_gspn.main(common + ["--preset", "tiny", "--batch", "2", "--num-points", "128",
                                    "--num-seeds", "8", "--gt-size", "16", "--dtype", "bf16",
                                    "--log-dir", str(tmp_path / "b")])
    assert bf.model.config.dtype == torch.bfloat16
    for state, d in ((obj, "o"), (bf, "b")):
        lines = [json.loads(x) for x in (tmp_path / d / "train.jsonl").read_text().splitlines()]
        assert len(lines) == 2 and all(np.isfinite(v) for ln in lines for v in ln.values())
        assert all(p.dtype == torch.float32 for p in state.model.parameters())
    saved = json.loads((tmp_path / "b" / "config.json").read_text())["model"]
    assert saved["dtype"] == "torch.bfloat16"


# ---------------------------------------------------------------------------
# stage 2
# ---------------------------------------------------------------------------


def _rp_world(jcfg, batch, seed=6):
    jb = _jbatch(batch)
    boxes = jnp.tile(jnp.asarray([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0]], jnp.float32), (B, 8, 1))
    feats = jb["features"] if jcfg.feature_dim else None
    v = jr.RPointNet(jcfg).init(jax.random.PRNGKey(0), jb["xyz"], boxes, features=feats,
                                valid=jb["valid"], train=False)
    return _perturbed(v, seed)


def _port_rp(jcfg, v):
    m = tr.RPointNet(rpointnet_config(jcfg))
    m.load_state_dict(convert.flax_to_state_dict(as_numpy_tree(v)), strict=True)
    return m.train()


def _box_noise(rng):
    """The GT boxes' jitter ``make_rpointnet_loss_fn`` draws from ``rng``."""
    return t(jax.random.normal(jax.random.split(rng, 4)[0], (B, I, 6), jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_feature_stage2_loss_matches_jax(dtype):
    """The stage-2 loss on jittered GT boxes with RGB features in the
    backbone: the loss, its terms and the heads' gradients against
    ``jax.value_and_grad``, and the backbone's first layer's gradient in
    its RGB columns."""
    jcfg = dataclasses.replace(jtrain_rp.tiny_rpointnet(18), ops_impl="xla", feature_dim=FDIM,
                               dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    batch = _scenes(1)
    v = _rp_world(jcfg, batch)
    rng = jax.random.PRNGKey(7)
    (_, (jmetrics, _)), jgrads = jax.jit(jax.value_and_grad(
        jsteps.make_rpointnet_loss_fn(jr.RPointNet(jcfg), I), has_aux=True))(
        v["params"], v["batch_stats"], _jbatch(batch), rng)
    tm = _port_rp(jcfg, v)
    total, metrics = tsteps.make_rpointnet_loss_fn(I)(tm, titerator.to_device(batch, "cpu"),
                                                      box_noise=_box_noise(rng))
    total.backward()
    tol = FWD if dtype == "f32" else BF16_LOSS
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), **tol,
                                   err_msg=k)
    want = _grads(jgrads)
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    # the heads after their max pool (the backbone's gradient passes the
    # pool's near-ties: tests/test_torch_rpointnet_train.py)
    heads = [k for k in want if k.startswith(("heads.cls.", "heads.box."))]
    if dtype == "f32":
        bench_slice.assert_grads_close({k: got[k] for k in heads}, {k: want[k] for k in heads})
    else:
        _assert_bf16_grads({k: got[k] for k in heads}, {k: want[k] for k in heads})
    w = "backbone.sa1.mlp.dense_0.weight"
    assert got[w].shape[1] == 3 + FDIM
    assert got[w][:, 3:].abs().sum() > 0 and want[w][:, 3:].abs().sum() > 0


def test_bf16_stage2_train_step_matches_optax():
    """One bfloat16 stage-2 step (``train_rpointnet --dtype bf16``, GT-box
    RoIs) against the JAX step with ``optax.adam``."""
    jcfg = dataclasses.replace(jtrain_rp.tiny_rpointnet(18), ops_impl="xla",
                               dtype=jnp.bfloat16)
    batch = _scenes(1, feature_dim=0)
    v = _rp_world(jcfg, batch)
    jmetrics, metrics, want, got = _one_adam_step(
        jsteps.make_rpointnet_loss_fn(jr.RPointNet(jcfg), I), v, _port_rp(jcfg, v),
        tsteps.make_rpointnet_loss_fn(I), batch,
        {"box_noise": _box_noise(jax.random.PRNGKey(100))})
    for k in ("cls", "box", "mask", "num_fg", "num_bg"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), **BF16_LOSS,
                                   err_msg=k)
    stats = {k for k in want if k.endswith((".mean", ".var"))}
    # the RoI MLP's first running statistics reach ~5e4 (absent GT boxes)
    _assert_after_adam({k: w for k, w in want.items() if k not in stats},
                       {k: g for k, g in got.items() if k not in stats})
    for k in stats:
        np.testing.assert_allclose(n(got[k]), n(want[k]), rtol=2e-2, atol=2 * LR, err_msg=k)


def test_train_rpointnet_bf16_with_a_frozen_bf16_gspn(tmp_path):
    """``train_rpointnet --dtype bf16 --gspn-ckpt``: both stages in bfloat16
    (the frozen GSPN too), finite losses."""
    common = ["--device", "cpu", "--preset", "tiny", "--steps", "1", "--batch", "2",
              "--num-points", "128", "--num-seeds", "8", "--log-every", "1", "--dtype", "bf16"]
    ttrain_gspn.main(common + ["--gt-size", "16", "--log-dir", str(tmp_path / "g")])
    state = ttrain_rp.main(common + ["--num-classes", "3", "--gspn-ckpt",
                                     str(tmp_path / "g" / "ckpt"), "--log-dir", str(tmp_path / "r")])
    assert state.model.config.dtype == torch.bfloat16 and state.step == 1
    line = (tmp_path / "r" / "train.jsonl").read_text().splitlines()[-1]
    assert np.isfinite(json.loads(line)["loss"])
