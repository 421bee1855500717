"""The port's evaluation (``gspn_tpu_torch.eval``) against the JAX package's
on the CPU, at the JAX eval tests' TINY shapes (B=2 x N=192, 8 seeds, 3
classes, ``--preset tiny``): the numpy copies of ``instance_eval`` and
``scannet_export`` give the JAX package's results and bytes exactly; the
eval loop, fed the JAX eval's weights (``torch_parity.randomized``,
carried across by ``convert.pipeline_state_dict``) and its noise
(``normal(PRNGKey(seed), (batch, seeds, latent))``), gives the JAX loop's
per-scene predictions and its summary line, a paired ``--ab-sa1-fps-segments``
arm included; and the CLI mirrors ``tests/test_run_eval.py``: dumps, the
paired arms, ``--artifact`` bitwise the live run, a train -> eval journey,
the width-signature check and the parse-time and not-ported errors."""

import contextlib
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gspn_tpu.eval import instance_eval as jie
from gspn_tpu.eval import run_eval as jrun
from gspn_tpu.eval import scannet_export as jexport
from gspn_tpu_torch import convert
from gspn_tpu_torch.eval import instance_eval as tie
from gspn_tpu_torch.eval import run_eval
from gspn_tpu_torch.eval import scannet_export as texport
from gspn_tpu_torch.models import pipeline as tpl
from gspn_tpu_torch.models.rpointnet import RPointNetConfig, SALayerSpec
from gspn_tpu_torch.train import train_gspn, train_rpointnet
from gspn_tpu_torch.train.config_io import config_from_jsonable
from tests.torch_parity import as_numpy_tree, n, randomized, t

TINY = ["--num-scenes", "4", "--batch", "2", "--num-points", "192", "--num-seeds", "8",
        "--num-classes", "3", "--preset", "tiny"]
CPU = ["--device", "cpu"]
# the JAX eval's arms on these weights: arm B takes sa1 in a pass of its own
# at 4 segments (the split path; the main arm's shared pass is exact)
PARITY = TINY + ["--bootstrap", "8", "--ab-sa1-fps-segments", "4"]
# the randomized weights' draw: at the eval's mask_thresh 0.5 the masks of
# the surviving proposals are neither empty nor full, and AP is not 0
WEIGHTS_SEED, WEIGHTS_STD = 3, 0.15
FIELDS = ("masks", "scores", "classes", "boxes", "valid")


def _summary(fn, argv):
    """``(fn(argv), the summary dict it printed last)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(argv)
    return res, json.loads(buf.getvalue().strip().splitlines()[-1])


def _without_rate(summary):
    return {k: v for k, v in summary.items() if k != "points_per_sec"}


def _same(a, b, where="result"):
    """Deep equality of results, NaN equal to NaN."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), (where, a, b)
    else:
        assert a == b, (where, a, b)


@pytest.fixture(scope="module")
def jax_eval():
    """The JAX eval's own ``main`` on ``PARITY``, its fresh weights replaced by
    randomized ones: its summary, its variables and each batch's raw
    predictions, main arm and arm B in turn."""
    real_init, real_pfd = jrun.init_pipeline_variables, jie.predictions_from_device
    taken, recorded = {}, []

    def init(cfg, key, n_pts, feature_dim=0):
        taken["variables"] = randomized(real_init(cfg, key, n_pts, feature_dim=feature_dim),
                                        WEIGHTS_SEED, WEIGHTS_STD)
        return taken["variables"]

    def record(preds, scene_valid=None):
        scenes = real_pfd(preds, scene_valid)
        recorded.append({"scenes": scenes, **{f: np.asarray(getattr(preds, f)) for f in FIELDS}})
        return scenes

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrun, "init_pipeline_variables", init)
        mp.setattr(jie, "predictions_from_device", record)
        res, summary = _summary(jrun.main, PARITY)
    return {"res": res, "summary": summary, "variables": taken["variables"],
            "main": recorded[0::2], "armB": recorded[1::2]}


@pytest.fixture(scope="module")
def port_eval(jax_eval):
    """The port's eval loop and summary on the same weights, batches and
    noise (``normal(PRNGKey(seed), (batch, seeds, latent))``, the draw the
    JAX ``infer`` makes from the key the JAX eval passes every batch)."""
    args = run_eval.parse_args(PARITY + CPU)
    cfg = run_eval.build_config(args)
    state = convert.pipeline_state_dict(as_numpy_tree(jax_eval["variables"]))
    eps = jax.random.normal(jax.random.PRNGKey(args.seed),
                            (args.batch, cfg.num_seeds, cfg.gspn.latent_dim), jnp.float32)
    outs = {"main": [], "armB": []}

    def recording(infer, arm):
        def call(xyz, valid, z_eps):
            preds = infer(xyz, valid, z_eps)
            outs[arm].append({f: n(getattr(preds, f)) for f in FIELDS})
            return preds
        return call

    run = run_eval.evaluate(
        recording(run_eval.live_infer(cfg, state, "cpu"), "main"),
        run_eval.scene_batches(args)(), t(eps),
        recording(run_eval.live_infer(run_eval.ab_config(cfg, args), state, "cpu"), "armB"))
    summary, res = run_eval.summarize(run, args)
    return {"run": run, "summary": summary, "res": res, **outs}


@pytest.mark.parametrize("arm", ["main", "armB"])
def test_eval_loop_matches_jax_predictions(jax_eval, port_eval, arm):
    """Each batch's predictions: masks, valid and classes equal, scores and
    boxes within rtol 1e-4 / atol 1e-5; the per-scene host predictions the
    AP is computed from: masks and classes equal, scores within 1e-4."""
    assert len(port_eval[arm]) == len(jax_eval[arm]) == 2
    for got, want in zip(port_eval[arm], jax_eval[arm], strict=True):
        for f in ("masks", "valid", "classes"):
            np.testing.assert_array_equal(got[f], want[f], f)
        for f in ("scores", "boxes"):
            np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-5, err_msg=f)
    masks = np.concatenate([o["masks"][o["valid"]] for o in port_eval[arm]])
    assert masks.any() and not masks.all()  # the comparison sees both outcomes
    want_scenes = [s for batch in jax_eval[arm] for s in batch["scenes"]]
    got_scenes = port_eval["run"].preds if arm == "main" else port_eval["run"].preds_b
    assert len(got_scenes) == 4
    for got, want in zip(got_scenes, want_scenes, strict=True):
        np.testing.assert_array_equal(got.masks, want.masks)
        np.testing.assert_array_equal(got.classes, want.classes)
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4, atol=1e-5)


def _as_preds(fields):
    return type("Preds", (), fields)  # attribute access to the recorded arrays


def test_eval_summary_matches_jax(jax_eval, port_eval):
    """The same summary line (AP, AP50, AP25, bootstrap CIs, arm B's APs and
    the paired differences; points a second aside) and per-class APs, with
    AP above 0 so that the comparison is not of zeros."""
    _same(_without_rate(port_eval["summary"]), _without_rate(jax_eval["summary"]))
    _same(port_eval["res"], jax_eval["res"])
    assert port_eval["summary"]["ap_25"] > 0
    assert {"ap_ci95", "ap_armB", "ap_diff", "ap_25_diff_mean"} <= set(port_eval["summary"])


def _random_scenes(seed, n_scenes=5, n_pts=60):
    """Predictions (two arms) and labels of random scenes: instances of
    3 classes with some unannotated points, predictions near a GT instance
    or random."""
    rng = np.random.default_rng(seed)
    preds_a, preds_b, labels = [], [], []
    for _ in range(n_scenes):
        inst = rng.integers(0, 5, n_pts).astype(np.int32)
        cls_of = rng.integers(1, 4, 5)
        sem = np.where(inst > 0, cls_of[inst], 0).astype(np.int32)
        sem[rng.random(n_pts) < 0.1] = 0  # unannotated
        labels.append((inst, sem))
        for preds in (preds_a, preds_b):
            r = int(rng.integers(0, 7))
            near = rng.integers(0, 5, r)
            masks = (inst[None] == near[:, None]) ^ (rng.random((r, n_pts)) < 0.2)
            preds.append(jie.ScenePredictions(
                masks=masks, scores=rng.random(r).astype(np.float32),
                classes=rng.integers(1, 4, r).astype(np.int32)))
    return preds_a, preds_b, labels


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("void_forgive", [False, True])
@pytest.mark.parametrize("min_region_size", [0, 12])
@pytest.mark.parametrize("match", ["greedy", "per_gt"])
def test_instance_eval_copy_matches_jax(match, min_region_size, void_forgive, seed):
    """``gt_from_labels``, ``evaluate_instances``, ``bootstrap_ci`` and
    ``bootstrap_diff`` of the port's copy against the JAX package's,
    exactly."""
    preds_a, preds_b, labels = _random_scenes(seed)
    gts = []
    for inst, sem in labels:
        got, want = tie.gt_from_labels(inst, sem), jie.gt_from_labels(inst, sem)
        assert got.inst_class == want.inst_class
        np.testing.assert_array_equal(got.inst_label, want.inst_label)
        np.testing.assert_array_equal(got.void_mask, want.void_mask)
        gts.append(want)
    mine = lambda ps: [tie.ScenePredictions(p.masks, p.scores, p.classes) for p in ps]  # noqa: E731
    mine_gts = [tie.SceneGT(g.inst_label, g.inst_class, g.void_mask) for g in gts]
    kw = dict(min_region_size=min_region_size, void_forgive=void_forgive, match=match)
    classes = [1, 2, 3]
    _same(tie.evaluate_instances(mine(preds_a), mine_gts, classes, **kw),
          jie.evaluate_instances(preds_a, gts, classes, **kw))
    _same(tie.bootstrap_ci(mine(preds_a), mine_gts, classes, n_boot=6, seed=seed, **kw),
          jie.bootstrap_ci(preds_a, gts, classes, n_boot=6, seed=seed, **kw))
    _same(tie.bootstrap_diff(mine(preds_a), mine(preds_b), mine_gts, classes, n_boot=6,
                             seed=seed, **kw),
          jie.bootstrap_diff(preds_a, preds_b, gts, classes, n_boot=6, seed=seed, **kw))


def test_predictions_from_device_takes_every_form():
    """An ``InstancePredictions`` of tensors, ``InferenceSession.run``'s tuple
    and ``.predict``'s dict give the JAX package's per-scene predictions."""
    rng = np.random.default_rng(0)
    arrays = {"masks": rng.random((2, 5, 12)) < 0.5, "scores": rng.random((2, 5), np.float32),
              "classes": rng.integers(1, 4, (2, 5)).astype(np.int32),
              "boxes": rng.random((2, 5, 6), np.float32), "valid": rng.random((2, 5)) < 0.6}
    scene_valid = rng.random((2, 12)) < 0.8
    want = jie.predictions_from_device(_as_preds(arrays), scene_valid)
    forms = [tpl.InstancePredictions(**{f: t(a) for f, a in arrays.items()}),
             tuple(t(arrays[f]) for f in tpl.PREDICTION_FIELDS), arrays]
    for form in forms:
        got = tie.predictions_from_device(form, t(scene_valid))
        for g, w in zip(got, want, strict=True):
            for f in ("masks", "scores", "classes"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


@pytest.mark.parametrize("count", [0, 3])
def test_scannet_export_copy_is_byte_identical(tmp_path, count):
    """The port's writer writes the JAX writer's bytes, and each reader reads
    the other's files back."""
    rng = np.random.default_rng(count)
    pred = tie.ScenePredictions(masks=rng.random((count, 40)) > 0.5,
                                scores=rng.random(count).astype(np.float32),
                                classes=np.array([1, 18, 7][:count]))
    texport.write_scannet_submission(tmp_path / "port", "scene0000_00", pred)
    jexport.write_scannet_submission(tmp_path / "jax", "scene0000_00", pred)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    assert texport.SCANNET_BENCHMARK_LABEL_IDS == jexport.SCANNET_BENCHMARK_LABEL_IDS
    want = jexport.read_scannet_submission(tmp_path / "jax", "scene0000_00")
    if count:
        np.testing.assert_array_equal(want.masks, pred.masks)
        np.testing.assert_allclose(want.scores, pred.scores, atol=1e-6)
    for read, d in ((texport.read_scannet_submission, "jax"),
                    (jexport.read_scannet_submission, "port")):
        back = read(tmp_path / d, "scene0000_00")
        for f in ("masks", "scores", "classes"):
            got, ref = getattr(back, f), getattr(want, f)
            assert got.dtype == ref.dtype and got.shape == ref.shape, f
            np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Checkpoints of ``train_gspn`` and ``train_rpointnet --gspn-ckpt`` at
    ``--preset tiny`` on the CPU, 2 steps each, at the eval's shapes."""
    root = tmp_path_factory.mktemp("trained")
    common = CPU + ["--preset", "tiny", "--steps", "2", "--batch", "2", "--num-points", "192",
                    "--num-seeds", "8", "--log-every", "1", "--ckpt-every", "2"]
    train_gspn.main(common + ["--gt-size", "16", "--log-dir", str(root / "gspn")])
    train_rpointnet.main(common + ["--num-classes", "3", "--gspn-ckpt", str(root / "gspn" / "ckpt"),
                                   "--log-dir", str(root / "rpointnet")])
    return root


def test_train_then_eval_journey(trained, tmp_path):
    """train_gspn, train_rpointnet over its frozen GSPN, then run_eval with
    both checkpoints, npz dumps; ``train_rpointnet`` wrote its config beside
    its checkpoints, which reads back as the stage config it trained."""
    saved = json.loads((trained / "rpointnet" / "config.json").read_text())
    registry = {c.__name__: c for c in (RPointNetConfig, SALayerSpec)}
    assert config_from_jsonable(saved["model"], registry) == train_rpointnet.tiny_rpointnet(3)
    assert saved["args"]["gspn_ckpt"] == str(trained / "gspn" / "ckpt")
    res, summary = _summary(run_eval.main, TINY + CPU + [
        "--gspn-ckpt", str(trained / "gspn" / "ckpt"),
        "--rpointnet-ckpt", str(trained / "rpointnet" / "ckpt"),
        "--dump-dir", str(tmp_path / "preds")])
    assert set(res) >= {"ap", "ap_50", "ap_25", "per_class"}
    assert summary["scenes"] == 4 and summary["points_per_sec"] > 0
    dumps = sorted((tmp_path / "preds").glob("*.npz"))
    assert len(dumps) == 4
    with np.load(dumps[0]) as z:
        assert {"masks", "scores", "classes"} <= set(z.files)
        assert z["masks"].ndim == 2


def test_run_eval_from_artifact_matches_live(trained, tmp_path):
    """``--artifact`` (a CPU artifact of ``export_serving``) serves the eval:
    the summary and every scene's dump equal the live run's, bit for bit;
    an artifact of another batch is refused."""
    from gspn_tpu_torch.serve import export_serving

    export = CPU + ["--preset", "tiny", "--num-points", "192", "--num-seeds", "8",
                    "--num-classes", "3"]
    art = export_serving.main(export + ["--batch", "2", "--out", str(tmp_path / "t.gspnt")])
    ckpts = ["--gspn-ckpt", str(trained / "gspn" / "ckpt"),
             "--rpointnet-ckpt", str(trained / "rpointnet" / "ckpt")]
    live = _summary(run_eval.main, TINY + CPU + ckpts + ["--dump-dir", str(tmp_path / "a")])[1]
    served = _summary(run_eval.main, TINY + CPU + ckpts + [
        "--artifact", str(art), "--dump-dir", str(tmp_path / "b")])[1]
    assert _without_rate(served) == _without_rate(live)
    for dump in sorted((tmp_path / "a").glob("*.npz")):
        with np.load(dump) as a, np.load(tmp_path / "b" / dump.name) as b:
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    other = export_serving.main(export + ["--batch", "1", "--out", str(tmp_path / "o.gspnt")])
    with pytest.raises(ValueError, match="batch x points"):
        run_eval.main(TINY + CPU + ["--artifact", str(other)])


def test_run_eval_dump_format_scannet(tmp_path):
    """The official layout: a .txt a scene that reads back with the reader,
    equal to the same run's npz dumps."""
    run_eval.main(TINY + CPU + ["--num-scenes", "2", "--dump-dir", str(tmp_path / "sub"),
                                "--dump-format", "scannet"])
    run_eval.main(TINY + CPU + ["--num-scenes", "2", "--dump-dir", str(tmp_path / "npz")])
    scenes = sorted((tmp_path / "sub").glob("scene_*.txt"))
    assert [p.stem for p in scenes] == ["scene_00000", "scene_00001"]
    for p in scenes:
        back = texport.read_scannet_submission(tmp_path / "sub", p.stem)
        with np.load(tmp_path / "npz" / f"{p.stem}.npz") as z:
            assert back.masks.shape[0] == z["masks"].shape[0]
            if len(back.scores):
                np.testing.assert_array_equal(back.masks, z["masks"])
                np.testing.assert_allclose(back.scores, z["scores"], atol=1e-6)


def test_run_eval_paired_ab():
    """--ab-fps-segments runs a second FPS arm on the same scenes and reports
    arm B's APs and the paired bootstrap differences; flag validation
    rejects a missing --bootstrap and the sharded path at parse time."""
    res, summary = _summary(run_eval.main, CPU + [
        "--num-scenes", "4", "--batch", "2", "--num-points", "256", "--num-seeds", "16",
        "--num-classes", "3", "--preset", "tiny", "--fps-segments", "2",
        "--fps-segment-mode", "spatial", "--ab-fps-segments", "1", "--bootstrap", "8"])
    assert set(res) >= {"ap", "ap_50", "ap_25"}
    for k in ("ap_armB", "ap_diff", "ap_diff_mean", "ap_50_diff", "ap_25_diff", "ap_ci95"):
        assert k in summary, sorted(summary)
    lo, hi = summary["ap_diff"]
    assert lo <= hi
    base = ["--num-scenes", "2", "--batch", "2", "--preset", "tiny", "--ab-fps-segments", "1"]
    for extra, said in (([], "bootstrap"), (["--bootstrap", "4", "--point-sharded"],
                                            "incompatible")):
        err = io.StringIO()
        with pytest.raises(SystemExit), contextlib.redirect_stderr(err):
            run_eval.parse_args(base + extra)
        assert said in err.getvalue()


@pytest.mark.parametrize("bad", [
    ["--artifact", "x.gspnt", "--point-sharded"],
    ["--data-rows", "2"],
    ["--point-sharded", "--data-rows", "3"],
    ["--artifact", "x.gspnt", "--num-scenes", "3"],
    ["--point-sharded", "--data-rows", "2", "--num-scenes", "3"],
    ["--scannet-dir", "a", "--partnet-dir", "b"],
    ["--ab-group-select", "strided", "--bootstrap", "4", "--artifact", "x.gspnt"],
])
def test_run_eval_flag_validation(bad):
    """Combinations the eval cannot run fail at parse time, as the JAX
    eval's do; the valid ones parse."""
    base = ["--num-scenes", "4", "--batch", "2", "--preset", "tiny"]
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        run_eval.parse_args(base + bad)
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        jrun.parse_args(base + [x.replace(".gspnt", ".gspnx") for x in bad])
    run_eval.parse_args(base + ["--artifact", "x.gspnt"])
    run_eval.parse_args(base + ["--point-sharded", "--data-rows", "2"])


def test_run_eval_width_mismatch_is_friendly_error(tmp_path):
    """A ``--width-mult 2`` checkpoint evaluated without the flag raises the
    config-mismatch error naming the flag; with it, it evaluates."""
    train_gspn.main(CPU + ["--steps", "1", "--batch", "2", "--num-points", "128",
                           "--num-seeds", "8", "--gt-size", "16", "--preset", "tiny",
                           "--log-every", "100", "--ckpt-every", "1", "--width-mult", "2",
                           "--log-dir", str(tmp_path / "w2")])
    argv = CPU + ["--num-scenes", "2", "--batch", "2", "--num-points", "128", "--num-seeds",
                  "8", "--num-classes", "3", "--preset", "tiny",
                  "--gspn-ckpt", str(tmp_path / "w2" / "ckpt")]
    with pytest.raises(ValueError, match="width-mult"):
        run_eval.main(argv)
    assert set(run_eval.main(argv + ["--width-mult", "2"])) >= {"ap", "per_class"}


EVAL_UNPORTED_FLAGS = [
    (["--scannet-dir", "x"], "Data loaders"), (["--partnet-dir", "x"], "Data loaders"),
    (["--morton"], "Data loaders"), (["--point-sharded"], "Parallel"),
    (["--point-sharded", "--data-rows", "2"], "Parallel"), (["--dtype", "bf16"], "Knob paths"),
]


@pytest.mark.parametrize("flags,item", EVAL_UNPORTED_FLAGS,
                         ids=lambda f: " ".join(f) if isinstance(f, list) else f)
def test_run_eval_unported_flags_raise(flags, item):
    with pytest.raises(NotImplementedError, match=f'ROADMAP.md, "{item}"'):
        run_eval.main(TINY + CPU + flags)


def test_run_eval_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="run_eval: .*--device cpu"):
        run_eval.main(TINY)
    assert run_eval.parse_args([]).device == "cuda"


def test_run_eval_flags_and_defaults_match_jax():
    """Every flag of the JAX eval, with its default (the port adds
    ``--device``), and the same preset configs."""
    ours, theirs = vars(run_eval.parse_args([])), vars(jrun.parse_args([]))
    assert set(ours) - set(theirs) == {"device"} and set(theirs) <= set(ours)
    assert {k: ours[k] for k in theirs} == theirs
    cfg = run_eval.build_config(run_eval.parse_args(["--preset", "tiny", "--width-mult", "2",
                                                     "--sa1-fps-segments", "4"]))
    assert cfg.rpointnet.roi_mlp == (64, 64) and cfg.sa1_fps_segments == 4
