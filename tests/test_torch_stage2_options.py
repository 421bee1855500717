"""Stage 2's options in the port against the JAX package, on the CPU at the
trainers' TINY widths (``tests/test_torch_rpointnet_train.py``'s world:
B=2 x N=256, 8 seeds, up to 4 GT instances, JAX's draws fed to the port):
``make_rpointnet_loss_fn``'s ``loss_weights``, ``gt_box_jitter`` and
``share_fps``, the same options in the DP-aware and point-sharded losses
(2 gloo ranks, ``tests/torch_stage2_ranks.py``), and
``RPointNetConfig.remat``.

Tolerances, and why:

- losses, their terms and BatchNorm statistics against JAX's: ``rtol=1e-5,
  atol=1e-5`` (``FWD``, the stage-2 tests' bound: matrix products and
  BatchNorm statistics sum in another order); gradients by
  ``bench_slice.assert_grads_close`` with the heads' max pool made to pick
  JAX's maxima, as ``tests/test_torch_rpointnet_train.py`` holds them;
  parameters after an Adam step as there (``rtol=1e-4, atol=1e-5``,
  ``2 * lr`` for a BatchNorm-fed bias);
- the DP-aware and point-sharded losses against JAX's single loss on the
  whole batch: ``FWD`` (each rank sums its part, then the ranks' sums);
- ``share_fps=False`` against ``True``, ``remat`` against no ``remat``:
  bitwise (the same operations on the same values; only what is kept for
  backward, or the number of FPS passes, differs).
"""

import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gspn_tpu import ops as jops
from gspn_tpu.models import gspn as jg
from gspn_tpu.models import rpointnet as jr
from gspn_tpu.train import steps as jsteps
from gspn_tpu_torch import ops
from gspn_tpu_torch.convert import flax_to_state_dict
from gspn_tpu_torch.data import iterator as titerator
from gspn_tpu_torch.train import steps as tsteps
from gspn_tpu_torch.utils import bench_slice
from tests import torch_stage2_ranks
from tests.test_torch_rpointnet_train import (  # noqa: F401 (the module fixture)
    B, FWD, I, JCFG, JGCFG, MAX_FORCED, S, _jax_heads, _port_gspn, _port_rpointnet, world,
)
from tests.test_torch_train import _bias_noise
from tests.torch_parity import as_numpy_tree, gspn_config, n, rpointnet_config, t

LOSS_WEIGHTS = {"cls_weight": 0.7, "box_weight": 1.5, "mask_weight": 0.3}
JITTER = 0.2
OPTS = dict(loss_weights=LOSS_WEIGHTS, gt_box_jitter=JITTER)
LR = 1e-3


def _jax_draws(world, jcfg, frozen, rng, v, jitter):
    """``make_rpointnet_loss_fn``'s draws from ``rng`` (box jitter noise, the
    frozen GSPN's CVAE noise) as the port's keyword arguments, and the RoI
    MLP output its heads pool over, the GT boxes jittered by ``jitter``."""
    jb = world["jb"]
    jitter_rng, drop_rng, roi_rng, z_rng = jax.random.split(rng, 4)
    box_noise = jax.random.normal(jitter_rng, (B, I, 6), jnp.float32)
    draws = {"box_noise": t(box_noise)}
    gt_boxes, _, present = jr.instance_gt_boxes(jb["xyz"], jb["inst_label"], jb["sem_label"], I)
    rois = jnp.where(present[..., None], gt_boxes + box_noise * jitter, 0.0)
    sa1_idx = None
    if frozen:
        z = jax.random.normal(z_rng, (B, S, JGCFG.latent_dim), jnp.float32)
        draws["z_eps"] = t(z)
        sa1_idx = jops.farthest_point_sample(jcfg.sa_layers[0].npoint, jb["xyz"], jb["valid"],
                                             impl="xla")
        gen = jax.jit(lambda x, s, v, z: world["jgm"].apply(
            world["gvars"], x, s, valid=v, train=False, z_eps=z).generated)(
            jb["xyz"], sa1_idx[:, :S], jb["valid"], z)
        rois = jnp.concatenate([jg.proposal_boxes(gen, jcfg.box_margin), rois], 1)
    heads = _jax_heads(jcfg)(v, jb["xyz"], rois, jb["valid"], sa1_idx,
                             {"dropout": drop_rng, "roi": roi_rng})
    return draws, np.asarray(heads["roi_mlp"]["__call__"][0])


def _jax_loss(world, frozen, jcfg=JCFG, **opts):
    fz = (world["jgm"], world["gvars"], S) if frozen else None
    return jsteps.make_rpointnet_loss_fn(jr.RPointNet(jcfg), I, frozen_gspn=fz, **opts)


@pytest.mark.parametrize("frozen", [True, False], ids=["gspn", "gt_boxes"])
def test_loss_weights_and_jitter_match_jax(world, frozen):
    """Non-default ``loss_weights`` and ``gt_box_jitter``, with and without
    the frozen GSPN: the loss, its terms, every gradient and the running
    statistics against ``jax.value_and_grad`` of JAX's loss with the same
    options, fed its draws; the total is the weighted sum of the terms."""
    v, rng = world["rvars"], jax.random.PRNGKey(11)
    (jtotal, (jmetrics, jstats)), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss(world, frozen, **OPTS), has_aux=True))(v["params"], v["batch_stats"],
                                                         world["jb"], rng)
    draws, jroi = _jax_draws(world, JCFG, frozen, rng, v, JITTER)
    tm = _port_rpointnet(JCFG, v)
    forced, _ = bench_slice.follow_max_ties(tm, jroi)
    fz = (_port_gspn(world["gvars"]), S) if frozen else None
    total, metrics = tsteps.make_rpointnet_loss_fn(I, fz, **OPTS)(
        tm, titerator.to_device(world["batch"], "cpu"), **draws)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal), **FWD)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), **FWD,
                                   err_msg=k)
    weighted = sum(w * float(metrics[k.removesuffix("_weight")].detach())
                   for k, w in LOSS_WEIGHTS.items())
    np.testing.assert_allclose(float(total.detach()), weighted, rtol=1e-6)
    assert len(forced) == 1 and forced[0] <= MAX_FORCED, forced
    bench_slice.assert_grads_close({k: p.grad for k, p in tm.named_parameters()},
                                   flax_to_state_dict(as_numpy_tree({"params": jgrads})))
    for k, w in flax_to_state_dict(as_numpy_tree({"batch_stats": jstats})).items():
        np.testing.assert_allclose(n(tm.state_dict()[k]), n(w), **FWD, err_msg=k)


def test_default_options_are_the_jax_defaults(world):
    """The defaults (``loss_weights`` None, ``gt_box_jitter`` 0.05,
    ``share_fps`` True) give bitwise the loss of passing them explicitly."""
    draws = {"box_noise": torch.randn((B, I, 6), generator=torch.Generator().manual_seed(2)),
             "z_eps": torch.randn((B, S, JGCFG.latent_dim),
                                  generator=torch.Generator().manual_seed(3))}
    batch = titerator.to_device(world["batch"], "cpu")
    fz = (_port_gspn(world["gvars"]), S)
    got = tsteps.make_rpointnet_loss_fn(I, fz)(_port_rpointnet(JCFG, world["rvars"]), batch,
                                               **draws)[0]
    want = tsteps.make_rpointnet_loss_fn(
        I, fz, loss_weights={"cls_weight": 1.0, "box_weight": 1.0, "mask_weight": 1.0},
        gt_box_jitter=0.05, share_fps=True)(_port_rpointnet(JCFG, world["rvars"]), batch,
                                            **draws)[0]
    assert torch.equal(got, want)


def _port_step(world, model_cfg, n_steps, draws_seed=5, **loss_opts):
    """``n_steps`` Adam steps of the port's stage-2 loss with the frozen
    GSPN, the model built from the JAX config ``model_cfg``; the noise of
    step i from a generator seeded ``draws_seed + i``.
    Returns the losses, step 1's gradients and the model."""
    tm = _port_rpointnet(model_cfg, world["rvars"])
    state = tsteps.TrainState(tm, tsteps.make_optimizer(tm, LR))
    step = tsteps.make_train_step(tsteps.make_rpointnet_loss_fn(
        I, (_port_gspn(world["gvars"]), S), **loss_opts))
    batch = titerator.to_device(world["batch"], "cpu")
    losses, grads = [], None
    for i in range(n_steps):
        losses.append(step(state, batch, generator=torch.Generator().manual_seed(draws_seed + i))
                      ["loss"])
        if grads is None:
            grads = {k: p.grad.clone() for k, p in tm.named_parameters()}
    return torch.stack(losses), grads, tm


def _assert_same(a, b):
    (la, ga, ma), (lb, gb, mb) = a, b
    assert torch.equal(la, lb), (la, lb)
    differ = [k for k in ga if not torch.equal(ga[k], gb[k])]
    assert not differ, differ[:5]
    sa, sb = ma.state_dict(), mb.state_dict()
    differ = [k for k in sa if not torch.equal(sa[k], sb[k])]
    assert not differ, differ[:5]


@pytest.fixture
def fps_calls(monkeypatch):
    """The pick counts of every ``ops.farthest_point_sample`` call."""
    calls = []
    real = ops.farthest_point_sample

    def counting(npoint, *a, **kw):
        calls.append(npoint)
        return real(npoint, *a, **kw)

    monkeypatch.setattr(ops, "farthest_point_sample", counting)
    return calls


def test_share_fps_false_is_bitwise_true_with_two_passes(world, fps_calls):
    """The counterpart of ``tests/test_steps_fps_sharing.py``: with
    ``share_fps=False`` the seeds take an FPS pass of their own and SA1
    samples its centres itself, and two steps (losses, step 1's gradients,
    parameters and running statistics) are bitwise the shared pass's, with
    the randomized RoIs and head dropout drawn from the same generator."""
    cfg = dataclasses.replace(JCFG, roi_randomize=True, head_dropout=0.3)
    shared = _port_step(world, cfg, 2)
    shared_calls, fps_calls[:] = list(fps_calls), []
    split = _port_step(world, cfg, 2, share_fps=False)
    _assert_same(split, shared)
    sa1, sa2 = JCFG.sa_layers[0].npoint, JCFG.sa_layers[1].npoint
    assert shared_calls == [max(S, sa1), sa2] * 2, shared_calls
    assert fps_calls == [S, sa1, sa2] * 2, fps_calls


@pytest.mark.parametrize("knobs", [{}, {"roi_randomize": True, "head_dropout": 0.3}],
                         ids=["plain", "randomized"])
def test_remat_is_bitwise_no_remat(world, knobs):
    """``remat=True`` recomputes each SA and FP module in backward, and two
    steps are bitwise the steps without it: losses, step 1's gradients,
    parameters and the running statistics (the recompute does not blend
    them again), with the non-default loss options on."""
    cfg = dataclasses.replace(JCFG, **knobs)
    _assert_same(_port_step(world, dataclasses.replace(cfg, remat=True), 2, **OPTS),
                 _port_step(world, cfg, 2, **OPTS))


def test_remat_recomputes_in_backward(world, monkeypatch):
    """Under ``remat`` the SA and FP modules run twice a step (the forward,
    then the recompute in backward), and once each without it or with no
    gradient."""
    from gspn_tpu_torch.nn import pointnet2

    counts = {}
    for cls in (pointnet2.PointNetSAModule, pointnet2.PointNetFPModule):
        real = cls.forward

        def counted(self, *a, _real=real, _name=cls.__name__, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(self, *a, **kw)

        monkeypatch.setattr(cls, "forward", counted)
    n_sa, n_fp = len(JCFG.sa_layers), len(JCFG.fp_mlps)
    for remat, times in ((True, 2), (False, 1)):
        counts.clear()
        _port_step(world, dataclasses.replace(JCFG, remat=remat), 1)
        assert counts == {"PointNetSAModule": times * n_sa, "PointNetFPModule": times * n_fp}
    counts.clear()
    with torch.no_grad():
        tm = _port_rpointnet(dataclasses.replace(JCFG, remat=True), world["rvars"])
        tm.backbone(t(world["batch"]["xyz"]), t(world["batch"]["valid"]))
    assert counts == {"PointNetSAModule": n_sa, "PointNetFPModule": n_fp}


def test_remat_step_matches_jax_remat(world):
    """One Adam step of the port's ``remat=True`` model against JAX's
    ``remat=True`` step (``nn.remat`` of every SA and FP module) with the
    non-default loss options, fed JAX's draws: the metrics, every gradient
    (from optax's first moment), the parameters and running statistics."""
    jcfg = dataclasses.replace(JCFG, remat=True)
    tx = optax.adam(LR)
    jstep = jsteps.make_train_step(_jax_loss(world, True, jcfg, **OPTS), tx)
    state = jsteps.TrainState.create(world["rvars"], tx)
    rng = jax.random.PRNGKey(21)
    draws, jroi = _jax_draws(world, jcfg, True, rng, world["rvars"], JITTER)
    state, jmetrics = jstep(state, world["jb"], rng)
    tm = _port_rpointnet(jcfg, world["rvars"])
    assert tm.config.remat
    tstate = tsteps.TrainState(tm, tsteps.make_optimizer(tm, LR))
    tstep = tsteps.make_train_step(tsteps.make_rpointnet_loss_fn(
        I, (_port_gspn(world["gvars"]), S), **OPTS))
    forced, _ = bench_slice.follow_max_ties(tm, jroi)
    metrics = tstep(tstate, titerator.to_device(world["batch"], "cpu"), **draws)
    assert len(forced) == 1 and forced[0] <= MAX_FORCED, forced
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), **FWD, err_msg=k)
    mu = flax_to_state_dict(as_numpy_tree({"params": state.opt_state[0].mu}))
    bench_slice.assert_grads_close({k: p.grad for k, p in tm.named_parameters()},
                                   {k: v / 0.1 for k, v in mu.items()})
    want = flax_to_state_dict(as_numpy_tree({"params": state.params,
                                             "batch_stats": state.batch_stats}))
    got = tm.state_dict()
    for k, w in want.items():
        atol = 2 * LR if _bias_noise(k) else 1e-5
        np.testing.assert_allclose(n(got[k]), n(w), rtol=1e-4, atol=atol, err_msg=k)


def test_remat_config_round_trips_through_config_io_and_checkpoints(world, tmp_path):
    """``remat`` survives ``save_config`` / ``load_config`` /
    ``config_from_jsonable``; a remat model's checkpoint restores into a
    model without it (the same state-dict keys) through
    ``restore_variable_collections``."""
    from gspn_tpu_torch.models.rpointnet import RPointNetConfig, SALayerSpec
    from gspn_tpu_torch.train.checkpoint import CheckpointManager, restore_variable_collections
    from gspn_tpu_torch.train.config_io import config_from_jsonable, load_config, save_config

    cfg = dataclasses.replace(rpointnet_config(JCFG), remat=True)
    save_config(tmp_path / "config.json", model=cfg)
    back = config_from_jsonable(load_config(tmp_path / "config.json")["model"],
                                {"RPointNetConfig": RPointNetConfig, "SALayerSpec": SALayerSpec})
    assert back == cfg and back.remat
    tm = _port_rpointnet(JCFG, world["rvars"])
    state = tsteps.TrainState(_port_rpointnet(dataclasses.replace(JCFG, remat=True),
                                              world["rvars"]), tsteps.make_optimizer(tm, LR))
    CheckpointManager(tmp_path / "ckpt").save(state)
    restored = restore_variable_collections(tmp_path / "ckpt", tm)
    tm.load_state_dict(restored, strict=True)
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in restored.items())
    with pytest.raises(FileNotFoundError):
        restore_variable_collections(tmp_path / "none", tm)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(world, tmp_path_factory):
    """What the 2 gloo ranks of ``tests/torch_stage2_ranks.py`` computed on
    the world's batch with JAX's draws, and JAX's single loss on the whole
    batch with the same options."""
    work = tmp_path_factory.mktemp("stage2_ranks")
    v, rng = world["rvars"], jax.random.PRNGKey(13)
    _, (jmetrics, _) = jax.jit(_jax_loss(world, True, **OPTS))(
        v["params"], v["batch_stats"], world["jb"], rng)
    draws, _ = _jax_draws(world, JCFG, True, rng, v, JITTER)
    case = {"rp_cfg": rpointnet_config(JCFG), "gspn_cfg": gspn_config(JGCFG),
            "rpointnet": _port_rpointnet(JCFG, v).state_dict(),
            "frozen": _port_gspn(world["gvars"]).state_dict(),
            "batch": titerator.to_device(world["batch"], "cpu"), "draws": draws,
            "seeds": S, "instances": I, **OPTS}
    torch.save(case, work / "case.pt")
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=torch_stage2_ranks.rank_main, args=(r, port, str(work)))
             for r in range(torch_stage2_ranks.W)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not alive, f"ranks {alive} did not finish"
    assert [p.exitcode for p in procs] == [0] * torch_stage2_ranks.W
    return ({k: float(m) for k, m in jmetrics.items()},
            [torch.load(work / f"rank{r}.pt") for r in range(torch_stage2_ranks.W)])


@pytest.mark.parametrize("loss", ["dp", "point_sharded"])
def test_sharded_losses_take_the_options(ranks, loss):
    """The DP-aware loss (a scene a rank) and the point-sharded loss (the
    seeds, points and RoIs over 2 ranks) with non-default ``loss_weights``
    and ``gt_box_jitter``: on every rank JAX's loss on the whole batch and
    each of its terms."""
    jmetrics, outs = ranks
    for r, out in enumerate(outs):
        for k, want in jmetrics.items():
            np.testing.assert_allclose(out[loss][k], want, **FWD, err_msg=f"rank {r} {k}")


def test_dp_remat_is_bitwise_no_remat(ranks):
    """Two DP steps (2 ranks) with ``remat`` are bitwise those without it on
    every rank: the recompute takes the ranks' BatchNorm statistics as the
    forward did."""
    for out in ranks[1]:
        (la, sa), (lb, sb) = out["dp_remat_True"], out["dp_remat_False"]
        assert torch.equal(la, lb)
        assert [k for k in sa if not torch.equal(sa[k], sb[k])] == []
