"""Point-sharded inference and training in the port
(``gspn_tpu_torch.parallel``: ``points``, ``scene``, ``spatial``,
``train_points``, ``make_mesh_2d``) on the CPU: 4 gloo ranks, started once
for the module with ``torch.multiprocessing`` (spawn) on a free port, run
every sharded case and write what they computed; the tests hold it against
the frozen ``tests/fixtures/inference_sharded.npz``, the port's
single-process functions and the JAX package's sharded functions on 4 of
``tests/conftest.py``'s virtual CPU devices, at TINY widths.

Tolerances, and why:

- the frozen sharded fixture: masks, classes and validity exact, scores
  and boxes within rtol 1e-4 / atol 1e-5 (``tests/test_fixtures.py``);
- sharded inference against the single-process ``make_inference_fn`` and
  the sharded backbone against ``Backbone``: masks, classes and validity
  exact, scores within rtol 1e-5 / atol 1e-6 (``tests/test_scene_sharded.py``),
  features, boxes and maps within the same; only a rank's MLP batch shapes
  differ;
- the sharded backbone against JAX's: rtol 1e-4 / atol 1e-5 (the port
  against the JAX package, ``tests/test_torch_models.py``);
- a sharded step (SGD at lr 1, so a parameter's change is its gradient)
  against the single-process step on the whole batch: the loss within rtol
  1e-5, parameters and BatchNorm statistics within rtol 3e-4 / atol 5e-4,
  the JAX package's own bounds (``tests/test_train_points.py``); against
  JAX's sharded step on the same draws: the loss within rtol 1e-5, the
  gradients by ``bench_slice.assert_grads_close``;
- ``all_gather_tiled``'s gradient against JAX's transpose of ``all_gather``
  under ``shard_map``: rtol 1e-6;
- the four ranks after a step, and a one-rank sharded run against the run
  without sharding: bitwise.

The module imports JAX only inside its fixtures and tests, so the spawned
ranks, which import it for ``_rank_main``, start without it.
"""

import dataclasses
import pathlib
import re
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gspn_tpu_torch.eval import run_eval
from gspn_tpu_torch.models import gspn as tg
from gspn_tpu_torch.models import pipeline as tp
from gspn_tpu_torch.models import rpointnet as tr
from gspn_tpu_torch.models.presets import set_pipeline_fps_segments
from gspn_tpu_torch.nn.layers import all_gather_tiled, cross_rank_statistics, glorot_init_
from gspn_tpu_torch.parallel import (
    PointMesh,
    make_mesh_2d,
    make_point_sharded_gspn_train_step,
    make_point_sharded_inference,
    make_point_sharded_rpointnet_train_step,
    make_sharded_backbone,
    make_spatial_inference,
    sharded_backbone_body,
)
from gspn_tpu_torch.train import steps as tsteps
from gspn_tpu_torch.train import train_gspn as ttrain
from gspn_tpu_torch.train import train_rpointnet as ttrain2
from gspn_tpu_torch.utils import bench_slice

W = 4  # ranks
B, NPTS, S, G, I = 4, 128, 8, 16, 4  # training: scenes, points, seeds, GT points, instances
STEP_BOUNDS = dict(rtol=3e-4, atol=5e-4)
INFER = ("fixture", "1nn_inbox", "3nn_inbox", "1nn_grid", "3nn_grid", "features",
         "spatial_fps", "hybrid")
TRAIN = ("stage1", "stage1_2x2", "stage1_random", "stage2", "stage2_2x2", "stage2_gt")
CLI = ["--device", "cpu", "--preset", "tiny", "--batch", "2", "--num-points", str(NPTS),
       "--num-seeds", str(S), "--log-every", "1"]
EVAL = ["--device", "cpu", "--preset", "tiny", "--num-scenes", "4", "--batch", "2",
        "--num-points", "192", "--num-seeds", str(S), "--num-classes", "3",
        "--score-thresh", "0", "--dump-dir"]


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _pipeline(cfg, state):
    model = tp.PipelineModel(cfg)
    model.load_state_dict(state)
    return model.eval()


def _train_model(case, name):
    if name.startswith("stage1"):
        m = tg.GSPN(case["gspn_cfg"], recognition=True)
        m.load_state_dict(case["gspn"])
    else:
        m = tr.RPointNet(case["rp_cfg"])
        m.load_state_dict(case["rpointnet"])
    return m.train()


def _frozen(case):
    m = tg.GSPN(case["gspn_cfg"])
    m.load_state_dict(case["frozen"])
    return m.eval()


def _sgd_step(model, step_fn, batch, draws):
    state = tsteps.TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0))
    metrics = step_fn(state, batch, **draws)
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.clone() for k, v in model.state_dict().items()})


def _draws(c):
    draws = {k: torch.from_numpy(np.array(v)) for k, v in c["draws"].items()}
    if "drawn_seed" in c:
        draws["generator"] = torch.Generator().manual_seed(c["drawn_seed"])
    return draws


def _single_step(case, name):
    """The single-process step of case ``name`` on the whole batch."""
    c = case[name]
    if name.startswith("stage1"):
        loss_fn = tsteps.make_gspn_loss_fn(S, G, seed_method=c.get("seed_method", "fps"))
    else:
        frozen = None if name == "stage2_gt" else (_frozen(case), S)
        loss_fn = tsteps.make_rpointnet_loss_fn(I, frozen)
    return _sgd_step(_train_model(case, name), tsteps.make_train_step(loss_fn),
                     _tensors(c["batch"]), _draws(c))


def _sharded_step(case, name, meshes, max_picks=None):
    """Case ``name``'s sharded step on this rank; ``max_picks``: the RoI
    MLP output whose max-pool picks the heads follow (this rank's RoIs)."""
    c = case[name]
    mesh = meshes["2x2" if name.endswith("2x2") else "1d"]
    if name.startswith("stage1"):
        step = make_point_sharded_gspn_train_step(case["gspn_cfg"], mesh, S, G,
                                                  seed_method=c.get("seed_method", "fps"))
    else:
        frozen = None if name == "stage2_gt" else (_frozen(case), S)
        step = make_point_sharded_rpointnet_train_step(case["rp_cfg"], mesh, I, frozen)
    model = _train_model(case, name)
    if max_picks is not None:
        forced, _ = bench_slice.follow_max_ties(model, max_picks)
        return (*_sgd_step(model, step, _tensors(c["batch"]), _draws(c)), forced)
    return _sgd_step(model, step, _tensors(c["batch"]), _draws(c))


def _rank_main(rank: int, port: int, work: str) -> None:
    """One rank of the module's group: every sharded case, written to
    ``work/rank<r>.pt``, then the three entry points under
    ``--point-sharded``."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=W)
    try:
        work = pathlib.Path(work)
        torch.manual_seed(1234 + rank)  # nothing may depend on the global generator
        torch.set_num_threads(1)  # four ranks on the host's cores, as torchrun sets them
        case = torch.load(work / "case.pt", weights_only=False)
        meshes = {"1d": make_mesh_2d(1, device="cpu"), "2x2": make_mesh_2d(2, 2, device="cpu")}
        out = {}
        with torch.inference_mode():
            for name in INFER:
                c = case[name]
                mesh = meshes["2x2" if name == "hybrid" else "1d"]
                kw = {"features": torch.from_numpy(c["features"])} if "features" in c else {}
                preds = make_point_sharded_inference(c["cfg"], mesh)(
                    _pipeline(c["cfg"], c["state"]), torch.from_numpy(c["xyz"]),
                    torch.from_numpy(c["valid"]), torch.from_numpy(c["z_eps"]), **kw)
                out[name] = {f: getattr(preds, f) for f in tp.PREDICTION_FIELDS}
            c = case["1nn_inbox"]
            preds = make_spatial_inference(c["cfg"], meshes["1d"])(
                _pipeline(c["cfg"], c["state"]), torch.from_numpy(c["xyz"]),
                torch.from_numpy(c["valid"]), torch.from_numpy(c["z_eps"]))
            out["spatial"] = {f: getattr(preds, f) for f in tp.PREDICTION_FIELDS}
            for name in ("backbone", "backbone_small_sa1"):
                c = case[name]
                bb = tr.RPointNet(c["cfg"])
                bb.load_state_dict(c["state"])
                out[name] = make_sharded_backbone(c["cfg"], meshes["1d"])(
                    bb.backbone.eval(), torch.from_numpy(c["xyz"]), torch.from_numpy(c["valid"]))
        for name in TRAIN:
            out[name] = _sharded_step(case, name, meshes)
        per = case["stage2_jax_roi_mlp"].shape[1] // W
        out["stage2_jax"] = _sharded_step(
            case, "stage2", meshes, case["stage2_jax_roi_mlp"][:, rank * per:(rank + 1) * per])
        x = (torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank).requires_grad_()
        w = torch.from_numpy(case["gather_w"][rank])
        (w * all_gather_tiled(x, 1, meshes["1d"].space)).sum().backward()
        out["gather_grad"] = x.grad
        torch.save(out, work / f"rank{rank}.pt")

        runs = {}
        state = ttrain.main(CLI + ["--gt-size", str(G), "--point-sharded", "--steps", "2",
                                   "--ckpt-every", "2", "--log-dir", str(work / f"gspn{rank}")])
        runs["gspn"] = state.model.state_dict()
        state = ttrain2.main(CLI + ["--num-classes", "3", "--max-instances", str(I),
                                    "--point-sharded", "--data-rows", "2", "--steps", "2",
                                    "--ckpt-every", "2",
                                    "--gspn-ckpt", str(work / "gspn0" / "ckpt"),
                                    "--log-dir", str(work / f"rpn{rank}")])
        runs["rpointnet"] = state.model.state_dict()
        run_eval.main(EVAL + [str(work / f"dumps{rank}"), "--point-sharded",
                              "--gspn-ckpt", str(work / "gspn0" / "ckpt"),
                              "--rpointnet-ckpt", str(work / "rpn0" / "ckpt")])
        torch.save(runs, work / f"runs{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inference_cases():
    """The sharded inference cases: the frozen fixture's TINY pipeline at its
    weights and noise, and TINY at 16 seeds with each mask projection and
    RoI sampling, with RGB features, with the spatial segmented FPS and on
    a 2 x 2 mesh; the sharded backbone at the fixture's weights and at an
    sa1 of 16 centres (its first FP level too small to shard)."""
    from gspn_tpu_torch import convert
    from tests.test_fixtures import _base_pipeline_variables, _load
    from tests.test_pipeline_eval import TINY
    from tests.torch_parity import as_numpy_tree, pipeline_config

    base = _load("instance_inference.npz")
    frozen = _load("inference_sharded.npz")
    state = convert.pipeline_state_dict(as_numpy_tree(_base_pipeline_variables(base)))
    xyz, valid = base["in/xyz"], base["in/valid"]
    tiny = pipeline_config(TINY)
    t16 = dataclasses.replace(tiny, num_seeds=16, mask_thresh=0.47)
    eps = torch.randn((2, 16, tiny.gspn.latent_dim), generator=torch.Generator().manual_seed(5))
    cases = {"fixture": {"cfg": tiny, "state": state, "xyz": xyz, "valid": valid,
                         "z_eps": frozen["in/z_eps"]}}
    for mode in ("1nn", "3nn"):
        for roi in ("inbox", "grid"):
            cfg = dataclasses.replace(
                t16, mask_project=mode, mask_thresh=0.455 if roi == "grid" else 0.47,
                rpointnet=dataclasses.replace(t16.rpointnet, roi_sample=roi))
            cases[f"{mode}_{roi}"] = {"cfg": cfg, "state": state}
    fcfg = dataclasses.replace(t16, gspn=dataclasses.replace(t16.gspn, feature_dim=3),
                               rpointnet=dataclasses.replace(t16.rpointnet, feature_dim=3))
    cases["features"] = {"cfg": fcfg, "features": np.random.default_rng(3).random(
        (2, NPTS, 3)).astype(np.float32), "state": tp.init_pipeline_variables(
            fcfg, torch.Generator().manual_seed(0), NPTS)}
    cases["spatial_fps"] = {"cfg": set_pipeline_fps_segments(t16, 2, "spatial"), "state": state}
    cases["hybrid"] = {"cfg": t16, "state": state}
    for name, c in cases.items():
        if name != "fixture":
            c.update(xyz=xyz, valid=valid, z_eps=eps.numpy())
    rp_state = {k[len("rpointnet."):]: v for k, v in state.items()
                if k.startswith("rpointnet.")}
    cases["backbone"] = {"cfg": tiny.rpointnet, "state": rp_state, "xyz": xyz, "valid": valid}
    small = dataclasses.replace(tiny.rpointnet, sa_layers=(
        tr.SALayerSpec(16, 0.4, 8, (8, 16)), tr.SALayerSpec(4, 0.8, 8, (16, 16))))
    sm = tr.RPointNet(small)
    glorot_init_(sm, torch.Generator().manual_seed(2))
    cases["backbone_small_sa1"] = {"cfg": small, "state": sm.state_dict(), "xyz": xyz,
                                   "valid": valid}
    return cases, frozen, base


def _jax_training():
    """The training cases' batches, draws and variables from the JAX
    package (as ``tests/test_torch_parallel.py`` makes them), and the JAX
    variables and configs for its sharded steps."""
    import jax
    import jax.numpy as jnp

    from gspn_tpu import ops as jops
    from gspn_tpu.data import synthetic as jsynthetic
    from gspn_tpu.data.instances import gather_seed_instances
    from gspn_tpu.models import gspn as jg
    from gspn_tpu.models import rpointnet as jr
    from gspn_tpu.train import train_gspn as jtrain
    from gspn_tpu.train import train_rpointnet as jtrain2
    from gspn_tpu_torch.convert import GSPN_TRAINING_ONLY, flax_to_state_dict
    from tests.test_torch_train import _perturbed
    from tests.torch_parity import as_numpy_tree, gspn_config, rpointnet_config

    jcfg = dataclasses.replace(jtrain.TINY_GSPN, ops_impl="xla")
    rcfg = dataclasses.replace(jtrain2.tiny_rpointnet(3), ops_impl="xla")
    batch = jsynthetic.scene_batch(np.random.default_rng(1), B, n_points=NPTS, max_instances=3,
                                   extent=2.0)
    ragged = dict(batch, valid=batch["valid"].copy())
    for i in range(B):  # each scene keeps another count of points
        ragged["valid"][i, NPTS // 2 + i * NPTS // (2 * B):] = False
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    jgm = jg.GSPN(jcfg)
    seeds = jops.farthest_point_sample(S, jb["xyz"], jb["valid"], impl="xla")
    gp, gv, _, _ = gather_seed_instances(jb["xyz"], jb["inst_label"], seeds, G)
    gvars = _perturbed(jax.jit(lambda x, s, v, p, pv: jgm.init(
        key, x, s, valid=v, gt_points=p, gt_valid=pv, z_rng=key, train=False))(
            jb["xyz"], seeds, jb["valid"], gp, gv), 11)
    boxes = jnp.tile(jnp.asarray([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0]], jnp.float32), (B, 4, 1))
    rvars = _perturbed(jax.jit(lambda x, b, v: jr.RPointNet(rcfg).init(
        key, x, b, valid=v, train=False))(jb["xyz"], boxes, jb["valid"]), 6)
    case = {"gspn_cfg": gspn_config(jcfg), "rp_cfg": rpointnet_config(rcfg),
            "gspn": flax_to_state_dict(as_numpy_tree(gvars)),
            "frozen": flax_to_state_dict(as_numpy_tree(gvars), skip=GSPN_TRAINING_ONLY),
            "rpointnet": flax_to_state_dict(as_numpy_tree(rvars))}
    _, z_rng = jax.random.split(jax.random.PRNGKey(3))
    eps = np.asarray(jax.random.normal(z_rng, (B, S, jcfg.latent_dim), jnp.float32))
    for name in ("stage1", "stage1_2x2"):
        case[name] = {"batch": batch, "draws": {"z_eps": eps}}
    case["stage1_random"] = {"batch": ragged, "draws": {}, "drawn_seed": 9,
                             "seed_method": "random"}
    jitter_rng, _, _, rng = jax.random.split(jax.random.PRNGKey(5), 4)
    draws2 = {"box_noise": np.asarray(jax.random.normal(jitter_rng, (B, I, 6), jnp.float32)),
              "z_eps": np.asarray(jax.random.normal(rng, (B, S, jcfg.latent_dim), jnp.float32))}
    for name in ("stage2", "stage2_2x2"):
        case[name] = {"batch": ragged, "draws": draws2}
    case["stage2_gt"] = {"batch": batch, "draws": {"box_noise": draws2["box_noise"]}}
    case["stage2_jax_roi_mlp"] = _jax_roi_mlp(rcfg, rvars, jgm, gvars, ragged, draws2)
    jax_world = {"jcfg": jcfg, "rcfg": rcfg, "gvars": gvars, "rvars": rvars, "batch": batch,
                 "ragged": ragged}
    return case, jax_world


def _jax_roi_mlp(rcfg, rvars, jgm, gvars, batch, draws):
    """The RoI MLP's output of JAX's stage-2 training forward on the loss's
    own RoIs (the frozen GSPN's proposals at ``draws["z_eps"]``, then the GT
    boxes jittered by ``draws["box_noise"]``), whose max-pool picks the
    port's heads follow in the comparison with JAX's sharded step."""
    import jax
    import jax.numpy as jnp

    from gspn_tpu import ops as jops
    from gspn_tpu.models import gspn as jg
    from gspn_tpu.models import rpointnet as jr
    from tests.test_torch_rpointnet_train import _jax_heads

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    gt_boxes, _, present = jr.instance_gt_boxes(jb["xyz"], jb["inst_label"], jb["sem_label"], I)
    gt_rois = jnp.where(present[..., None], gt_boxes + draws["box_noise"] * 0.05, 0.0)
    sa1_n = rcfg.sa_layers[0].npoint
    fps_all = jops.farthest_point_sample(max(S, sa1_n), jb["xyz"], jb["valid"], impl="xla")
    gen = jgm.apply(gvars, jb["xyz"], fps_all[:, :S], valid=jb["valid"], train=False,
                    z_eps=jnp.asarray(draws["z_eps"])).generated
    rois = jnp.concatenate([jg.proposal_boxes(gen, rcfg.box_margin), gt_rois], 1)
    _, drop_rng, roi_rng, _ = jax.random.split(jax.random.PRNGKey(5), 4)
    heads = _jax_heads(rcfg)(rvars, jb["xyz"], rois, jb["valid"], fps_all[:, :sa1_n],
                             {"dropout": drop_rng, "roi": roi_rng})
    return np.asarray(heads["roi_mlp"]["__call__"][0])


def _jax_sharded_steps(jw):
    """JAX's point-sharded step of each stage on a 4-device space mesh, SGD
    at lr 1: ``{name: (metrics, state dict after)}``."""
    import jax
    import jax.numpy as jnp
    import optax

    from gspn_tpu.parallel import make_mesh as jmake_mesh
    from gspn_tpu.parallel.train_points import (
        make_point_sharded_gspn_train_step as jgspn_step,
    )
    from gspn_tpu.parallel.train_points import (
        make_point_sharded_rpointnet_train_step as jrpn_step,
    )
    from gspn_tpu.train import steps as jsteps
    from gspn_tpu_torch.convert import flax_to_state_dict
    from tests.torch_parity import as_numpy_tree

    mesh = jmake_mesh(W, axis="space")
    tx = optax.sgd(1.0)
    out = {}
    for name, step, variables, batch, key in (
            ("stage1", jgspn_step(jw["jcfg"], tx, mesh, S, G), jw["gvars"], jw["batch"], 3),
            ("stage2", jrpn_step(jw["rcfg"], tx, mesh, I, frozen_gspn=(jw["jcfg"], jw["gvars"],
                                                                      S)),
             jw["rvars"], jw["ragged"], 5)):
        st, m = step(jsteps.TrainState.create(variables, tx),
                     {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(key))
        out[name] = ({k: float(v) for k, v in m.items()}, flax_to_state_dict(
            as_numpy_tree({"params": st.params, "batch_stats": st.batch_stats})))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The cases, what the 4 ranks wrote, and the JAX package's sharded
    steps (computed while the ranks run)."""
    work = tmp_path_factory.mktemp("point_sharded")
    case, frozen, base = _inference_cases()
    train_case, jw = _jax_training()
    case.update(train_case)
    case["gather_w"] = np.random.default_rng(4).standard_normal((W, 2, 3 * W)).astype(np.float32)
    torch.save(case, work / "case.pt")
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, str(work))) for r in range(W)]
    for p in procs:
        p.start()
    try:
        jax_steps = _jax_sharded_steps(jw)
    finally:
        for p in procs:
            p.join(timeout=300)
        alive = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert not alive, f"ranks {alive} did not finish"
    assert [p.exitcode for p in procs] == [0] * W
    ranks = [torch.load(work / f"rank{r}.pt") for r in range(W)]
    runs = [torch.load(work / f"runs{r}.pt") for r in range(W)]
    return dict(work=work, case=case, frozen=frozen, ranks=ranks, runs=runs, jw=jw,
                jax_steps=jax_steps)


def _single_preds(c):
    kw = {"features": torch.from_numpy(c["features"])} if "features" in c else {}
    with torch.inference_mode():
        return tp.make_inference_fn(c["cfg"])(
            _pipeline(c["cfg"], c["state"]), torch.from_numpy(c["xyz"]),
            torch.from_numpy(c["valid"]), z_eps=torch.from_numpy(c["z_eps"]), **kw)


def _assert_preds_equal(got: dict, want, score_tol=dict(rtol=1e-5, atol=1e-6)):
    for f in ("masks", "valid", "classes"):
        np.testing.assert_array_equal(got[f].numpy(), getattr(want, f).numpy(), err_msg=f)
    for f in ("scores", "boxes"):
        np.testing.assert_allclose(got[f].numpy(), getattr(want, f).numpy(), err_msg=f,
                                   **score_tol)


def test_sharded_inference_reproduces_frozen_fixture(world):
    """4 ranks reproduce ``inference_sharded.npz`` (the JAX package's
    ``make_point_sharded_inference`` on 4 devices) at its weights and
    ``in/z_eps``, on every rank."""
    z = world["frozen"]
    for r in range(W):
        got = world["ranks"][r]["fixture"]
        for f in ("masks", "valid", "classes"):
            np.testing.assert_array_equal(got[f].numpy(), z[f"out/{f}"], err_msg=f)
        for f in ("scores", "boxes"):
            np.testing.assert_allclose(got[f].numpy(), z[f"out/{f}"], rtol=1e-4, atol=1e-5,
                                       err_msg=f)
    assert z["out/valid"].any()


@pytest.mark.parametrize("name", INFER[1:])
def test_sharded_inference_equals_single_process(world, name):
    """Each mask projection x RoI sampling, RGB features, the spatial
    segmented FPS and a 2 x 2 mesh: the sharded pipeline's predictions
    (every rank the whole batch's) are the single-process pipeline's; the
    masks hold points on both sides of the threshold."""
    want = _single_preds(world["case"][name])
    for r in range(W):
        _assert_preds_equal(world["ranks"][r][name], want)
    m = want.masks[want.valid]
    assert m.any() and not m.all()


def test_spatial_inference_equals_single_process(world):
    """``make_spatial_inference`` (seeds and RoIs sharded, the backbone
    whole on every rank) against the single-process pipeline."""
    want = _single_preds(world["case"]["1nn_inbox"])
    for r in range(W):
        _assert_preds_equal(world["ranks"][r]["spatial"], want)


@pytest.mark.parametrize("name", ["backbone", "backbone_small_sa1"])
def test_sharded_backbone_equals_backbone(world, name):
    """``make_sharded_backbone``'s gathered map against ``Backbone``'s, at
    the fixture's weights and at an sa1 of 16 centres, whose first FP level
    (4 targets a rank) runs replicated."""
    c = world["case"][name]
    bb = tr.RPointNet(c["cfg"])
    bb.load_state_dict(c["state"])
    with torch.inference_mode():
        want = bb.backbone.eval()(torch.from_numpy(c["xyz"]), torch.from_numpy(c["valid"]))
    for r in range(W):
        np.testing.assert_allclose(world["ranks"][r][name].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_sharded_backbone_matches_jax_sharded_backbone(world):
    """The port's sharded backbone against ``gspn_tpu.parallel.points.
    make_sharded_backbone`` on a 4-device space mesh, same weights and
    scenes."""
    import jax.numpy as jnp

    from gspn_tpu.parallel import make_mesh as jmake_mesh
    from gspn_tpu.parallel.points import make_sharded_backbone as jmake_sharded_backbone
    from tests.test_fixtures import _base_pipeline_variables, _load
    from tests.test_pipeline_eval import TINY

    base = _load("instance_inference.npz")
    rv = _base_pipeline_variables(base)["rpointnet"]
    bb_vars = {coll: tree["backbone"] for coll, tree in rv.items()}
    want = jmake_sharded_backbone(TINY.rpointnet, jmake_mesh(W, axis="space"))(
        bb_vars, jnp.asarray(base["in/xyz"]), jnp.asarray(base["in/valid"]))
    np.testing.assert_allclose(world["ranks"][0]["backbone"].numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", TRAIN)
def test_sharded_step_equals_single_process_step(world, name):
    """Stage 1 (1-D, 2 x 2, seeds drawn at random from the step's
    generator) and stage 2 (over a frozen GSPN on a ragged batch, 1-D and
    2 x 2, and on GT boxes alone): one sharded step is the single-process
    step on the whole batch, and every rank holds the same state."""
    metrics, sd = world["ranks"][0][name]
    want_metrics, want_sd = _single_step(world["case"], name)
    np.testing.assert_allclose(metrics["loss"], want_metrics["loss"], rtol=1e-5)
    for k in want_metrics:
        np.testing.assert_allclose(metrics[k], want_metrics[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert sd.keys() == want_sd.keys()
    for k, w in want_sd.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), err_msg=k, **STEP_BOUNDS)
    before = world["case"]["gspn" if name.startswith("stage1") else "rpointnet"]
    assert any(not torch.equal(v, before[k]) for k, v in sd.items() if k.endswith(".weight"))
    for r in range(1, W):
        m_r, sd_r = world["ranks"][r][name]
        assert m_r == metrics and all(torch.equal(sd_r[k], sd[k]) for k in sd), r


@pytest.mark.parametrize("name", ["stage1", "stage2"])
def test_sharded_step_matches_jax_sharded_step(world, name):
    """The port's 1-D sharded step against ``gspn_tpu.parallel.train_points``'
    on a 4-device space mesh, the same batch and draws: the loss and its
    terms, the gradients (the change under SGD at lr 1) and the BatchNorm
    statistics. In stage 2 the heads' max pool follows JAX's picks where
    float32 rounding settles a near-tie one way in one framework and the
    other way in the other (``bench_slice.follow_max_ties``): a few cells on each
    rank. The port's single-process step differs from JAX's steps there in
    the same way, and JAX's sharded and single-process steps agree."""
    if name == "stage2":
        for r in range(W):
            forced = world["ranks"][r]["stage2_jax"][2]
            assert len(forced) == 1 and forced[0] <= 8, (r, forced)
    metrics, sd = world["ranks"][0][name if name == "stage1" else "stage2_jax"][:2]
    jmetrics, jsd = world["jax_steps"][name]
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=1e-5, atol=1e-6, err_msg=k)
    before = world["case"]["gspn" if name == "stage1" else "rpointnet"]
    params = [k for k in before if k.endswith((".weight", ".bias", ".scale"))]
    bench_slice.assert_grads_close({k: before[k] - sd[k] for k in params},
                                   {k: torch.as_tensor(before[k] - jsd[k]) for k in params})
    for k in before:
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(sd[k].numpy(), np.asarray(jsd[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_all_gather_tiled_gradient_matches_jax_transpose(world):
    """Each rank's loss ``sum(w_r * all_gather(x))``: the gradient reaching
    rank ``i``'s ``x`` is the ranks' weights summed, sliced to ``i``'s
    part, as JAX transposes ``all_gather(tiled=True)`` under
    ``shard_map``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from gspn_tpu.parallel import make_mesh as jmake_mesh

    w = world["case"]["gather_w"]
    x = np.concatenate([np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r for r in range(W)],
                       axis=1)

    def per_shard(xs, ws):
        return jax.grad(lambda v: jnp.sum(ws[0] * jax.lax.all_gather(
            v, "space", axis=1, tiled=True)))(xs)

    want = jax.shard_map(per_shard, mesh=jmake_mesh(W, axis="space"),
                         in_specs=(P(None, "space"), P("space")), out_specs=P(None, "space"),
                         check_vma=False)(jnp.asarray(x), jnp.asarray(w))
    got = np.concatenate([world["ranks"][r]["gather_grad"].numpy() for r in range(W)], axis=1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(got, np.concatenate(np.split(w.sum(0), W, axis=1), axis=1),
                               rtol=1e-6)


def test_point_sharded_trainers_write_from_rank_0_alone(world):
    """``train_gspn --point-sharded`` (1 x 4) and ``train_rpointnet
    --point-sharded --data-rows 2`` (2 x 2) on that checkpoint, 2 steps
    each: every rank the same model, rank 0 alone writing the checkpoint,
    the config and the metric lines."""
    work = world["work"]
    for stage, d in (("gspn", "gspn"), ("rpointnet", "rpn")):
        sd0 = world["runs"][0][stage]
        for r in range(1, W):
            assert all(torch.equal(world["runs"][r][stage][k], sd0[k]) for k in sd0), (stage, r)
            assert not list((work / f"{d}{r}").rglob("*.*")), (stage, r)
        assert (work / f"{d}0" / "ckpt" / "ckpt_2.pt").exists()
        assert (work / f"{d}0" / "config.json").exists()
        assert len((work / f"{d}0" / "train.jsonl").read_text().splitlines()) == 2


def test_point_sharded_train_gspn_equals_the_run_without_it(world, tmp_path):
    """The 4-rank ``--point-sharded`` stage-1 run trains what the
    single-process run of the same flags trains (Adam for 2 steps at lr
    1e-3: the step bounds, and ``2 * lr`` a step on the BatchNorm-fed
    biases and the running means they feed, whose gradients are rounding
    noise)."""
    from tests.test_torch_train import _bias_noise

    state = ttrain.main(CLI + ["--gt-size", str(G), "--steps", "2", "--ckpt-every", "2",
                               "--log-dir", str(tmp_path / "single")])
    got, want = world["runs"][0]["gspn"], state.model.state_dict()
    for k, w in want.items():
        tol = dict(rtol=0, atol=2 * 2e-3) if _bias_noise(k) else dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k, **tol)


def test_point_sharded_run_eval_equals_live_eval(world, tmp_path):
    """``run_eval --point-sharded`` on 4 ranks over both checkpoints: rank
    0 alone dumps, and every scene's dump equals the single-process eval's
    on the same noise (masks and classes exact, scores within rtol 1e-5 /
    atol 1e-6)."""
    work = world["work"]
    run_eval.main(EVAL + [str(tmp_path / "live"), "--gspn-ckpt", str(work / "gspn0" / "ckpt"),
                          "--rpointnet-ckpt", str(work / "rpn0" / "ckpt")])
    live = sorted((tmp_path / "live").iterdir())
    assert [p.name for p in live] == sorted(p.name for p in (work / "dumps0").iterdir())
    assert len(live) == 4
    for p in live:
        got, want = np.load(work / "dumps0" / p.name), np.load(p)
        np.testing.assert_array_equal(got["masks"], want["masks"])
        np.testing.assert_array_equal(got["classes"], want["classes"])
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-6)
    for r in range(1, W):
        assert not (work / f"dumps{r}").exists()


def _fake_mesh(n_data=1, n_space=W):
    return PointMesh(world=None, space=None, data=None, n_data=n_data, n_space=n_space,
                     data_index=0, space_index=0, device=torch.device("cpu"))


def _gspn_cfg():
    from gspn_tpu_torch.train.train_gspn import TINY_GSPN

    return TINY_GSPN


REFUSALS = {
    "stage1 num_seeds": (lambda: make_point_sharded_gspn_train_step(
        _gspn_cfg(), _fake_mesh(), 6, G), "num_seeds=6 not divisible by 4 shards"),
    "stage1 random with data rows": (lambda: make_point_sharded_gspn_train_step(
        _gspn_cfg(), _fake_mesh(2, 2), S, G, seed_method="random"),
        "seed_method='random' draws over the full batch and cannot bit-match"),
    "head_dropout": (lambda: make_point_sharded_rpointnet_train_step(
        dataclasses.replace(ttrain2.tiny_rpointnet(3), head_dropout=0.5), _fake_mesh(), 16),
        "point-sharded training does not support head_dropout>0"),
    "roi_randomize": (lambda: make_point_sharded_rpointnet_train_step(
        dataclasses.replace(ttrain2.tiny_rpointnet(3), roi_randomize=True), _fake_mesh(), 16),
        "point-sharded training does not support roi_randomize"),
    "stage2 total RoIs": (lambda: make_point_sharded_rpointnet_train_step(
        ttrain2.tiny_rpointnet(3), _fake_mesh(), 6), "total RoIs=6 not divisible by 4 shards"),
    "stage2 num_seeds": (lambda: make_point_sharded_rpointnet_train_step(
        ttrain2.tiny_rpointnet(3), _fake_mesh(), 4, frozen_gspn=(tg.GSPN(_gspn_cfg()), 6)),
        "num_seeds=6 not divisible by 4 shards"),
    "stage2 sa1 npoint": (lambda: make_point_sharded_rpointnet_train_step(
        dataclasses.replace(ttrain2.tiny_rpointnet(3), sa_layers=(
            tr.SALayerSpec(62, 0.4, 16, (16,)),)), _fake_mesh(), 8),
        "sa1 npoint=62 not divisible by 4 shards"),
    "inference num_seeds": (lambda: make_point_sharded_inference(
        tp.PipelineConfig(num_seeds=14), _fake_mesh()), "num_seeds=14 not divisible by mesh axis 4"),
    "spatial num_seeds": (lambda: make_spatial_inference(
        tp.PipelineConfig(num_seeds=14), _fake_mesh()), "num_seeds=14 not divisible by mesh axis 4"),
    "inference sa1 npoint": (lambda: make_point_sharded_inference(tp.PipelineConfig(
        rpointnet=dataclasses.replace(tr.RPointNetConfig(), sa_layers=(
            tr.SALayerSpec(1022, 0.1, 32, (32,)),))), _fake_mesh()),
        "sa1 npoint=1022 not divisible by 4 shards"),
    "backbone N": (lambda: sharded_backbone_body(
        tr.RPointNet(ttrain2.tiny_rpointnet(3)).backbone.eval(), _fake_mesh(),
        torch.zeros(1, 130, 3), None), "N=130 not divisible by 4 shards"),
    "backbone BN without cross-rank statistics": (lambda: sharded_backbone_body(
        tr.RPointNet(ttrain2.tiny_rpointnet(3)).backbone.train(), _fake_mesh(),
        torch.zeros(1, 128, 3), None), "sharded training with BN needs cross-shard statistics"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_point_sharded_refusals(name):
    """The JAX package's refusals, in its words, before any collective
    runs."""
    build, said = REFUSALS[name]
    with pytest.raises(ValueError, match=re.escape(said)):
        build()


def test_backbone_bn_statistics_follow_the_group():
    """Under ``cross_rank_statistics`` the backbone's BatchNorms carry the
    group, the refusal above lifts, and the group leaves after the block."""
    bb = tr.RPointNet(ttrain2.tiny_rpointnet(3)).backbone.train()
    group = object()
    with cross_rank_statistics(bb, group):
        assert all(m.group is group for m in bb.modules() if hasattr(m, "group"))
    assert all(m.group is None for m in bb.modules() if hasattr(m, "group"))


@pytest.mark.parametrize("rows,cols,said", [(2, None, "1 devices not divisible into 2 data rows"),
                                            (1, 2, "need 2 devices (1x2), have 1")])
def test_make_mesh_2d_refuses_a_world_that_does_not_fit(rows, cols, said, monkeypatch):
    """JAX's messages when the world does not make the mesh; the one-rank
    world it set up is torn down again."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=re.escape(said)):
        make_mesh_2d(rows, cols, device="cpu")
    assert not dist.is_initialized()
