"""Data-parallel training in the port (``gspn_tpu_torch.parallel``) on the
CPU: 2 gloo ranks, started once for the module with ``torch.multiprocessing``
(spawn) on a free port, run every DP case and write what they computed;
the tests hold it against the port's single-process step on the whole
batch and against the JAX package's ``make_dp_train_step`` on a 2-device
mesh (``tests/conftest.py``'s virtual CPU devices), on the same batch and
draws, at the trainers' TINY widths (B=4 x N=128, 2 scenes a rank).

Tolerances, and why:

- the DP step against the single-process step on the whole batch: the
  loss within ``rtol=1e-6``, parameters and BatchNorm statistics within
  ``rtol=5e-5, atol=2e-5`` after one SGD step at lr 1 (so a parameter's
  change is its gradient), the JAX package's own bounds for its DP step
  (``tests/test_parallel_train.py``); only the order of float sums
  differs (the ranks' partial sums, then the gradient mean);
- the DP step against JAX's DP step: the loss within ``rtol=1e-5``, the
  parameter changes (gradients) by ``bench_slice.assert_grads_close``,
  the BatchNorm statistics within ``rtol=1e-5, atol=1e-5``, the bounds of
  the port's single-process step against JAX's (``tests/test_torch_train.py``);
- the two ranks after a step, a DP run against itself resumed, and a
  one-rank DP run against the run without ``--dp``: bitwise equal.

The module imports JAX only inside its fixtures, so the spawned ranks,
which import this module for ``_rank_main``, start without it.
"""

import dataclasses
import pathlib
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gspn_tpu_torch.models import gspn as tg
from gspn_tpu_torch.models import pipeline as tp
from gspn_tpu_torch.models import rpointnet as tr
from gspn_tpu_torch.parallel import DataMesh, make_dp_inference, make_dp_train_step, make_mesh
from gspn_tpu_torch.parallel import dp as tdp
from gspn_tpu_torch.parallel import shard_batch
from gspn_tpu_torch.train import steps as tsteps
from gspn_tpu_torch.train import train_gspn as ttrain
from gspn_tpu_torch.train import train_rpointnet as ttrain2

W, B, NPTS, S, G, I = 2, 4, 128, 8, 16, 4  # ranks, scenes, points, seeds, GT points, instances
STEP_BOUNDS = dict(rtol=5e-5, atol=2e-5)
TRAIN = ["--device", "cpu", "--preset", "tiny", "--batch", str(B), "--num-points", str(NPTS),
         "--num-seeds", str(S), "--log-every", "1"]
STAGE1 = TRAIN + ["--gt-size", str(G)]
STAGE2 = TRAIN + ["--num-classes", "3", "--max-instances", str(I)]


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _gspn(case):
    m = tg.GSPN(case["gspn_cfg"], recognition=True)
    m.load_state_dict(case["gspn"])
    return m.train()


def _frozen(case):
    m = tg.GSPN(case["gspn_cfg"])
    m.load_state_dict(case["frozen"])
    return m.eval()


def _rpointnet(case):
    m = tr.RPointNet(case["rp_cfg"])
    m.load_state_dict(case["rpointnet"])
    return m.train()


def _step(case, name, model, loss_fn, batch, mesh=None):
    """One SGD(lr=1) step of ``model`` on ``batch`` with case ``name``'s
    draws (a generator seeded by ``drawn_seed`` where it has one):
    ``(metrics, state dict after)``."""
    state = tsteps.TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0))
    step = tsteps.make_train_step(loss_fn) if mesh is None else make_dp_train_step(loss_fn, mesh)
    draws = {k: torch.from_numpy(v) for k, v in case[name]["draws"].items()}
    if "drawn_seed" in case[name]:
        draws["generator"] = torch.Generator().manual_seed(case[name]["drawn_seed"])
    metrics = step(state, batch, **draws)
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.clone() for k, v in model.state_dict().items()})


def _loss_fn(case, name, **dp):
    if name == "stage2":
        return tsteps.make_rpointnet_loss_fn(I, (_frozen(case), S), **dp)
    return tsteps.make_gspn_loss_fn(S, G, seed_method=case[name].get("seed_method", "fps"), **dp)


def _model(case, name):
    return _rpointnet(case) if name == "stage2" else _gspn(case)


CASES = ("plain", "ragged", "drawn", "stage2")


def _rank_main(rank: int, port: int, work: str) -> None:
    """One rank of the module's DP group: every DP case, written to
    ``work/rank<r>.pt``, then the trainers under ``--dp``."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=W)
    try:
        work = pathlib.Path(work)
        torch.manual_seed(1234 + rank)  # nothing may depend on the global generator
        case = torch.load(work / "case.pt", weights_only=False)
        mesh = make_mesh("cpu", n_ranks=W)
        out = {}
        for name in CASES:
            loss_fn = _loss_fn(case, name, dp_group=mesh.group, dp_size=mesh.size)
            batch = shard_batch(mesh, _tensors(case[name]["batch"]))
            out[name] = _step(case, name, _model(case, name), loss_fn, batch, mesh)
        infer = make_dp_inference(tp.make_inference_fn(case["pipe_cfg"]), mesh)
        model = tp.PipelineModel(case["pipe_cfg"])
        model.load_state_dict(case["pipe"])
        pb = _tensors(case["plain"]["batch"])
        with torch.no_grad():
            preds = infer(model.eval(), pb["xyz"], pb["valid"], seed=3)
        out["inference"] = {f: getattr(preds, f) for f in tp.PREDICTION_FIELDS}
        torch.save(out, work / f"rank{rank}.pt")

        runs = {}
        state = ttrain.main(STAGE1 + ["--dp", "--steps", "2", "--ckpt-every", "2",
                                      "--log-dir", str(work / f"main{rank}")])
        runs["main"] = state.model.state_dict()
        ttrain.main(STAGE1 + ["--dp", "--steps", "1", "--ckpt-every", "1",
                              "--log-dir", str(work / "resume")])
        state = ttrain.main(STAGE1 + ["--dp", "--steps", "2", "--ckpt-every", "1", "--resume",
                                      "--log-dir", str(work / "resume")])
        runs["resumed"] = state.model.state_dict()
        state = ttrain2.main(STAGE2 + ["--dp", "--steps", "2", "--ckpt-every", "2",
                                       "--gspn-ckpt", str(work / "main0" / "ckpt"),
                                       "--log-dir", str(work / f"stage2_{rank}")])
        runs["stage2"] = state.model.state_dict()
        torch.save(runs, work / f"runs{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_world():
    """The cases' batches, draws and variables from the JAX package, its DP
    steps on a 2-device mesh, and the port's inputs for them."""
    import jax
    import jax.numpy as jnp
    import optax

    from gspn_tpu import ops as jops
    from gspn_tpu.data import synthetic as jsynthetic
    from gspn_tpu.data.instances import gather_seed_instances
    from gspn_tpu.models import gspn as jg
    from gspn_tpu.models import rpointnet as jr
    from gspn_tpu.parallel import make_dp_train_step as jmake_dp_train_step
    from gspn_tpu.parallel import make_mesh as jmake_mesh
    from gspn_tpu.parallel import replicate as jreplicate
    from gspn_tpu.parallel import shard_batch as jshard_batch
    from gspn_tpu.train import steps as jsteps
    from gspn_tpu.train import train_gspn as jtrain
    from gspn_tpu.train import train_rpointnet as jtrain2
    from gspn_tpu_torch.convert import GSPN_TRAINING_ONLY, flax_to_state_dict
    from tests.test_torch_train import _perturbed
    from tests.torch_parity import as_numpy_tree, gspn_config, rpointnet_config

    jcfg = dataclasses.replace(jtrain.TINY_GSPN, ops_impl="xla")
    rcfg = dataclasses.replace(jtrain2.tiny_rpointnet(3), ops_impl="xla")
    plain = jsynthetic.scene_batch(np.random.default_rng(1), B, n_points=NPTS, max_instances=3,
                                   extent=2.0)
    ragged = dict(plain, valid=plain["valid"].copy())
    for i in range(B):  # each scene, and so each rank, keeps another count of points
        ragged["valid"][i, NPTS // 2 + i * NPTS // (2 * B):] = False
    jb = {k: jnp.asarray(v) for k, v in plain.items()}
    key = jax.random.PRNGKey(0)
    jgm = jg.GSPN(jcfg)
    seeds = jops.farthest_point_sample(S, jb["xyz"], jb["valid"], impl="xla")
    gp, gv, _, _ = gather_seed_instances(jb["xyz"], jb["inst_label"], seeds, G)
    gvars = _perturbed(jax.jit(lambda x, s, v, p, pv: jgm.init(
        key, x, s, valid=v, gt_points=p, gt_valid=pv, z_rng=key, train=False))(
            jb["xyz"], seeds, jb["valid"], gp, gv), 11)
    boxes = jnp.tile(jnp.asarray([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0]], jnp.float32), (B, 4, 1))
    jrm = jr.RPointNet(rcfg)
    rvars = _perturbed(jax.jit(lambda x, b, v: jrm.init(key, x, b, valid=v, train=False))(
        jb["xyz"], boxes, jb["valid"]), 6)

    pipe_cfg = tp.PipelineConfig(gspn=gspn_config(jcfg), rpointnet=rpointnet_config(rcfg),
                                 num_seeds=S)
    mesh = jmake_mesh(W)
    tx = optax.sgd(1.0)
    jax_dp = {}
    case = {"gspn_cfg": gspn_config(jcfg), "rp_cfg": rpointnet_config(rcfg),
            "gspn": flax_to_state_dict(as_numpy_tree(gvars)),
            "frozen": flax_to_state_dict(as_numpy_tree(gvars), skip=GSPN_TRAINING_ONLY),
            "rpointnet": flax_to_state_dict(as_numpy_tree(rvars)),
            "pipe_cfg": pipe_cfg,
            "pipe": tp.init_pipeline_variables(pipe_cfg, torch.Generator().manual_seed(0), NPTS)}
    step = jmake_dp_train_step(jsteps.make_gspn_loss_fn(jgm, S, G, dp_axis="data", dp_size=W),
                               tx, mesh)
    for name, batch in (("plain", plain), ("ragged", ragged)):
        k = jax.random.PRNGKey(3)
        _, z_rng = jax.random.split(k)
        eps = jax.random.normal(z_rng, (B, S, jcfg.latent_dim), jnp.float32)
        case[name] = {"batch": batch, "draws": {"z_eps": np.asarray(eps)}}
        st, m = step(jreplicate(mesh, jsteps.TrainState.create(gvars, tx)),
                     jshard_batch(mesh, {k2: jnp.asarray(v) for k2, v in batch.items()}), k)
        jax_dp[name] = ({k2: float(v) for k2, v in m.items()}, flax_to_state_dict(
            as_numpy_tree({"params": st.params, "batch_stats": st.batch_stats})))
    case["drawn"] = {"batch": ragged, "draws": {}, "drawn_seed": 9, "seed_method": "random"}
    k = jax.random.PRNGKey(5)
    jitter_rng, _, _, rng = jax.random.split(k, 4)
    case["stage2"] = {"batch": ragged, "draws": {
        "box_noise": np.asarray(jax.random.normal(jitter_rng, (B, I, 6), jnp.float32)),
        "z_eps": np.asarray(jax.random.normal(rng, (B, S, jcfg.latent_dim), jnp.float32))}}
    step = jmake_dp_train_step(jsteps.make_rpointnet_loss_fn(
        jrm, I, frozen_gspn=(jgm, gvars, S), dp_axis="data", dp_size=W), tx, mesh)
    _, m = step(jreplicate(mesh, jsteps.TrainState.create(rvars, tx)),
                jshard_batch(mesh, {k2: jnp.asarray(v) for k2, v in ragged.items()}), k)
    jax_dp["stage2"] = ({k2: float(v) for k2, v in m.items()}, None)
    return case, jax_dp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The cases, the JAX DP steps, each case's single-process step on the
    whole batch, and what the 2 ranks wrote."""
    work = tmp_path_factory.mktemp("dp")
    case, jax_dp = _jax_world()
    torch.save(case, work / "case.pt")
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, str(work))) for r in range(W)]
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
    assert [p.exitcode for p in procs] == [0] * W
    single = {name: _step(case, name, _model(case, name), _loss_fn(case, name),
                          _tensors(case[name]["batch"])) for name in CASES}
    ranks = [torch.load(work / f"rank{r}.pt") for r in range(W)]
    runs = [torch.load(work / f"runs{r}.pt") for r in range(W)]
    return dict(work=work, case=case, jax_dp=jax_dp, single=single, ranks=ranks, runs=runs)


def _assert_state_close(got: dict, want: dict, **tol):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k, **tol)


@pytest.mark.parametrize("name", CASES)
def test_dp_step_equals_single_process_step(world, name):
    """Stage 1 on a plain batch, on a ragged one (each rank another count
    of valid points), with the draws from the step's generator
    (``seed_method="random"``: the seed uniforms, then the CVAE noise, at
    the whole batch's shape), and stage 2 over a frozen GSPN on the ragged
    batch: the DP step is the single-process step on the whole batch."""
    metrics, sd = world["ranks"][0][name]
    want_metrics, want_sd = world["single"][name]
    np.testing.assert_allclose(metrics["loss"], want_metrics["loss"], rtol=1e-6)
    for k in want_metrics:
        np.testing.assert_allclose(metrics[k], want_metrics[k], rtol=1e-5, err_msg=k)
    _assert_state_close(sd, want_sd, **STEP_BOUNDS)
    moved = [k for k, v in sd.items() if k.endswith(".weight")
             and not torch.equal(v, world["case"]["rpointnet" if name == "stage2" else "gspn"][k])]
    assert moved


@pytest.mark.parametrize("name", CASES)
def test_dp_ranks_hold_the_same_state(world, name):
    """After a step every rank holds the same parameters, statistics and
    metrics, bit for bit."""
    (m0, sd0), (m1, sd1) = (world["ranks"][r][name] for r in range(W))
    assert m0 == m1
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)


@pytest.mark.parametrize("name", ["plain", "ragged"])
def test_dp_stage1_step_matches_jax_dp_step(world, name):
    """The port's DP step against ``gspn_tpu.parallel.make_dp_train_step``
    on a 2-device mesh, the same batch and CVAE noise: loss and terms, the
    gradients (the parameters' change under SGD at lr 1) and the
    BatchNorm statistics."""
    from gspn_tpu_torch.utils import bench_slice

    metrics, sd = world["ranks"][0][name]
    jmetrics, jsd = world["jax_dp"][name]
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=1e-5, err_msg=k)
    before = world["case"]["gspn"]
    params = [k for k in before if k.endswith((".weight", ".bias", ".scale"))]
    bench_slice.assert_grads_close({k: before[k] - sd[k] for k in params},
                                   {k: torch.as_tensor(before[k] - jsd[k]) for k in params})
    for k in before:
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(sd[k].numpy(), np.asarray(jsd[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_dp_stage2_loss_matches_jax_dp_step(world):
    """Stage 2's DP loss and terms against the JAX package's DP step on
    the same ragged batch, GT-box jitter and frozen-GSPN noise."""
    metrics, _ = world["ranks"][0]["stage2"]
    jmetrics, _ = world["jax_dp"]["stage2"]
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_dp_inference_gathers_each_ranks_scenes(world):
    """``make_dp_inference``: each rank's scenes with the noise of
    ``rank_generator(seed, rank)``, gathered in rank order on every rank,
    equal to the single-process call on each rank's rows."""
    case = world["case"]
    model = tp.PipelineModel(case["pipe_cfg"])
    model.load_state_dict(case["pipe"])
    infer = tp.make_inference_fn(case["pipe_cfg"])
    b = _tensors(case["plain"]["batch"])
    per = B // W
    with torch.no_grad():
        parts = [infer(model.eval(), b["xyz"][r * per:(r + 1) * per],
                       b["valid"][r * per:(r + 1) * per],
                       generator=tdp.rank_generator(3, r, "cpu")) for r in range(W)]
    for r in range(W):
        got = world["ranks"][r]["inference"]
        for f in tp.PREDICTION_FIELDS:
            assert torch.equal(got[f], torch.cat([getattr(p, f) for p in parts])), f


def test_train_gspn_dp_writes_from_rank_0_alone(world):
    """``train_gspn.main --dp`` on 2 ranks for 2 steps: rank 0 writes the
    checkpoint, the config and 2 metric lines; rank 1 writes nothing."""
    work = world["work"]
    assert (work / "main0" / "ckpt" / "ckpt_2.pt").exists()
    assert (work / "main0" / "config.json").exists()
    assert len((work / "main0" / "train.jsonl").read_text().splitlines()) == 2
    assert not list((work / "main1").rglob("*.*"))
    sd0, sd1 = (world["runs"][r]["main"] for r in range(W))
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    saved = torch.load(work / "main0" / "ckpt" / "ckpt_2.pt", weights_only=True)["model"]
    assert all(torch.equal(saved[k], sd0[k]) for k in sd0)


def test_train_gspn_dp_equals_the_run_without_dp(world, tmp_path):
    """The 2-rank ``--dp`` run trains what the single-process run of the same
    flags trains (Adam for 2 steps at lr 1e-3: the parameters within the
    single-step bounds plus ``2 * lr`` a step on the BatchNorm-fed biases and
    the running means they feed, whose gradients are rounding noise)."""
    from tests.test_torch_train import _bias_noise

    state = ttrain.main(STAGE1 + ["--steps", "2", "--ckpt-every", "2",
                                  "--log-dir", str(tmp_path / "single")])
    got, want = world["runs"][0]["main"], state.model.state_dict()
    for k, w in want.items():
        if _bias_noise(k):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=2 * 2e-3,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_train_gspn_dp_resume(world):
    """Under ``--dp``, 1 step, a checkpoint and ``--resume`` for 1 more is
    the 2-step run, bit for bit, on both ranks."""
    for r in range(W):
        got, want = world["runs"][r]["resumed"], world["runs"][r]["main"]
        assert all(torch.equal(got[k], want[k]) for k in want), r


def test_train_rpointnet_dp(world):
    """``train_rpointnet.main --dp`` over the DP stage-1 run's checkpoint:
    2 steps, both ranks the same model, rank 0 alone writing."""
    work = world["work"]
    sd0, sd1 = (world["runs"][r]["stage2"] for r in range(W))
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    assert (work / "stage2_0" / "ckpt" / "ckpt_2.pt").exists()
    assert not list((work / "stage2_1").rglob("*.*"))


def test_one_rank_dp_run_is_the_run_without_dp(tmp_path, monkeypatch):
    """Without a launcher the world is this one rank (set up and torn down
    by the trainer): ``--dp`` then trains the run without it, bit for bit."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    argv = STAGE1 + ["--steps", "2", "--ckpt-every", "2", "--batch", "2"]
    dp = ttrain.main(argv + ["--dp", "--log-dir", str(tmp_path / "dp")])
    assert not dist.is_initialized()
    plain = ttrain.main(argv + ["--log-dir", str(tmp_path / "plain")])
    want = plain.model.state_dict()
    assert all(torch.equal(dp.model.state_dict()[k], want[k]) for k in want)


def _mesh(size=2):
    return DataMesh(group=object(), rank=0, size=size, device=torch.device("cpu"))


def test_dp_step_refuses_a_loss_that_is_not_dp_aware():
    mesh = _mesh()
    with pytest.raises(ValueError, match="DP-aware"):
        make_dp_train_step(tsteps.make_gspn_loss_fn(S, G), mesh)
    with pytest.raises(ValueError, match="DP-aware"):
        make_dp_train_step(tsteps.make_gspn_loss_fn(S, G, dp_group=object(), dp_size=2), mesh)


def test_dp_step_refuses_a_dp_size_mismatch():
    mesh = _mesh()
    with pytest.raises(ValueError, match="dp_size=4 but the mesh has 2 ranks"):
        make_dp_train_step(tsteps.make_rpointnet_loss_fn(I, dp_group=mesh.group, dp_size=4),
                           mesh)


def test_dp_stage2_loss_refuses_dropout_and_randomized_rois():
    """The DP stage-2 loss refuses the draws whose shapes are a rank's (the
    JAX package's rule), before any collective runs."""
    cfg = dataclasses.replace(ttrain2.tiny_rpointnet(3), head_dropout=0.5)
    loss_fn = tsteps.make_rpointnet_loss_fn(I, dp_group=object(), dp_size=2)
    batch = _tensors({"xyz": np.zeros((1, 16, 3), np.float32), "valid": np.ones((1, 16), bool),
                      "inst_label": np.zeros((1, 16), np.int32),
                      "sem_label": np.zeros((1, 16), np.int32)})
    with pytest.raises(ValueError, match="head_dropout > 0 or roi_randomize"):
        loss_fn(tr.RPointNet(cfg).train(), batch, generator=torch.Generator())


def test_dp_with_point_sharded_keeps_jax_error():
    for main in (ttrain.main, ttrain2.main):
        with pytest.raises(SystemExit, match="--dp and --point-sharded are mutually exclusive"):
            main(["--device", "cpu", "--dp", "--point-sharded"])


def test_mesh_without_rendezvous_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh("cpu")
    assert not dist.is_initialized()


def test_shard_batch_and_dp_slice():
    """Rank ``r`` of ``n`` takes rows ``[r * B / n, (r + 1) * B / n)`` of every
    array and of ``scene_ids``; a batch that does not split raises."""
    batch = {"xyz": torch.arange(12).reshape(4, 3), "scene_ids": ["a", "b", "c", "d"]}
    mesh = DataMesh(group=object(), rank=1, size=2, device=torch.device("cpu"))
    got = shard_batch(mesh, batch)
    assert got["scene_ids"] == ["c", "d"] and torch.equal(got["xyz"], batch["xyz"][2:])
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        shard_batch(dataclasses.replace(mesh, size=3), batch)
    assert tsteps.dp_slice(batch["xyz"], None, 2) is batch["xyz"]


def test_dp_trainer_refuses_a_batch_that_does_not_split(tmp_path, monkeypatch):
    monkeypatch.setattr(ttrain, "make_mesh", lambda device: _mesh(3))
    with pytest.raises(SystemExit, match="--batch 4 must be divisible by the 3 ranks"):
        ttrain.main(STAGE1 + ["--dp", "--steps", "1", "--log-dir", str(tmp_path)])
