"""The trainers and the eval of the port (``gspn_tpu_torch``) on real-layout
data (``--scannet-dir``, ``--shapenet-dir``, ``--partnet-dir``, ``--morton``)
against the JAX package's on the CPU, at the TINY presets, on files written
here in the release layouts (``tests/test_torch_data.py``'s writers).

Tolerances, and why:

- the data stream (the first batch of each source, every array and the
  ``scene_ids``) and the eval's dump names: equal, the JAX side on its
  NumPy point-prep route and the port on ``impl="plain"``;
- the first step's loss and terms on a real-layout batch, with the JAX
  side's variables and noise: ``rtol=atol=1e-5``, and stage 1's gradients by
  ``bench_slice.assert_grads_close``, the bounds of
  ``tests/test_torch_train.py`` and ``tests/test_torch_knobs_train.py``.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gspn_tpu import ops as jops
from gspn_tpu.data import instances as jinstances
from gspn_tpu.data import native as jnative
from gspn_tpu.data.iterator import DeterministicBatches as JBatches
from gspn_tpu.eval import run_eval as jrun_eval
from gspn_tpu.models import gspn as jg
from gspn_tpu.models import rpointnet as jr
from gspn_tpu.train import steps as jsteps
from gspn_tpu.train import train_gspn as jtrain
from gspn_tpu.train import train_rpointnet as jtrain2
from gspn_tpu_torch.convert import flax_to_state_dict
from gspn_tpu_torch.data.iterator import DeterministicBatches, to_device
from gspn_tpu_torch.eval import run_eval
from gspn_tpu_torch.models import gspn as tg
from gspn_tpu_torch.models import rpointnet as tr
from gspn_tpu_torch.train import steps as tsteps
from gspn_tpu_torch.train import train_gspn as ttrain
from gspn_tpu_torch.train import train_rpointnet as ttrain2
from gspn_tpu_torch.utils import bench_slice
from tests.test_torch_data import write_partnet_h5, write_scannet_dir, write_shapenet_h5
from tests.test_torch_train import _perturbed
from tests.torch_parity import as_numpy_tree, gspn_config, rpointnet_config, t

FWD = dict(rtol=1e-5, atol=1e-5)
B, NPTS, S, G, I = 2, 256, 8, 16, 4
TINY = ["--preset", "tiny", "--batch", str(B), "--num-points", str(NPTS), "--num-seeds", str(S)]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A ScanNet npz directory (3 scans), a ShapeNet h5 directory (2 files,
    4 categories) and a PartNet one (2 files, probed keys)."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    (root / "shapenet").mkdir()
    write_shapenet_h5(root / "shapenet" / "a.h5", rng, n=300)
    write_shapenet_h5(root / "shapenet" / "b.h5", rng, b=9, n=300)
    (root / "partnet").mkdir()
    write_partnet_h5(root / "partnet" / "a.h5", rng, n=400)
    write_partnet_h5(root / "partnet" / "b.h5", rng, b=5, n=400)
    return {"scannet": str(write_scannet_dir(root)), "shapenet": str(root / "shapenet"),
            "partnet": str(root / "partnet")}


@pytest.fixture
def jax_plain(monkeypatch):
    monkeypatch.setattr(jnative, "_lib", lambda: None)


SOURCES = {  # the trainers' data flags, the directories from ``data``
    "scannet": ["--scannet-dir", "{scannet}"],
    "scannet_morton": ["--scannet-dir", "{scannet}", "--morton"],
    "shapenet_category": ["--shapenet-dir", "{shapenet}", "--shapenet-category", "2"],
    "shapenet_morton": ["--shapenet-dir", "{shapenet}", "--morton"],
    "partnet": ["--partnet-dir", "{partnet}"],
    "partnet_morton": ["--partnet-dir", "{partnet}", "--morton"],
    "synthetic_morton": ["--morton"],
    "objects_morton": ["--synthetic-objects", "--morton"],
}


def _flags(source, data):
    return [f.format(**data) for f in SOURCES[source]]


def _first_batches(argv):
    """The JAX trainer's and the port's first batch for ``argv``."""
    jb = JBatches(jtrain.make_sample_fn(jtrain.parse_args(argv)), B, 0).batch_at(0)
    tb = DeterministicBatches(ttrain.make_sample_fn(ttrain.parse_args(argv), impl="plain"),
                              B, 0).batch_at(0)
    return jb, tb


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_first_batch_matches_the_jax_trainer(data, jax_plain, source):
    """``make_sample_fn`` of both trainers on the same flags: the same first
    batch (ScanNet crops sorted inside the crop, the other sources by
    ``morton_sort_batch``), the ``scene_ids`` included."""
    jb, tb = _first_batches(TINY + _flags(source, data))
    assert tb.keys() == jb.keys()
    for k, w in jb.items():
        if isinstance(w, list):
            assert tb[k] == w
        else:
            assert tb[k].dtype == w.dtype, k
            np.testing.assert_array_equal(tb[k], w, err_msg=k)
    if source.startswith("scannet"):
        assert tb["features"].shape == (B, NPTS, 3) and len(tb["scene_ids"]) == B


def _jsonl(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


@pytest.mark.parametrize("source", ["scannet_morton", "shapenet_category", "partnet",
                                    "synthetic_morton"])
def test_train_gspn_runs_on_each_source(data, tmp_path, source):
    """``train_gspn.main`` for 2 steps: finite metrics, a checkpoint, and
    the feature width the data carries (RGB for ScanNet)."""
    state = ttrain.main(CPU + TINY + _flags(source, data) + [
        "--steps", "2", "--gt-size", str(G), "--log-every", "1", "--log-dir", str(tmp_path)])
    assert state.step == 2
    assert state.model.config.feature_dim == (3 if source.startswith("scannet") else 0)
    lines = _jsonl(tmp_path / "train.jsonl")
    assert len(lines) == 2 and all(np.isfinite(v) for rec in lines for v in rec.values())
    assert (tmp_path / "ckpt" / "ckpt_2.pt").exists()


@pytest.mark.parametrize("source", ["scannet", "scannet_morton", "partnet_morton"])
def test_train_rpointnet_runs_on_each_source(data, tmp_path, source):
    """``train_rpointnet.main`` for 2 steps: over a frozen GSPN trained on
    the same source, or (PartNet) on jittered GT boxes."""
    flags = CPU + TINY + _flags(source, data) + ["--log-every", "1"]
    gspn = []
    if source.startswith("scannet"):
        ttrain.main(flags + ["--steps", "1", "--gt-size", str(G),
                             "--log-dir", str(tmp_path / "g")])
        gspn = ["--gspn-ckpt", str(tmp_path / "g" / "ckpt")]
    state = ttrain2.main(flags + gspn + ["--steps", "2", "--num-classes", "18",
                                         "--log-dir", str(tmp_path / "r")])
    assert state.step == 2
    lines = _jsonl(tmp_path / "r" / "train.jsonl")
    assert len(lines) == 2 and all(np.isfinite(v) for rec in lines for v in rec.values())


def test_stage1_first_step_on_scannet_crops_matches_jax(data, jax_plain):
    """The stage-1 loss, its terms and every gradient on the first ScanNet
    batch (RGB features) with the JAX side's variables and CVAE noise."""
    jb, tb = _first_batches(TINY + _flags("scannet_morton", data))
    jcfg = dataclasses.replace(jtrain.TINY_GSPN, ops_impl="xla", feature_dim=3)
    jx = {k: jnp.asarray(v) for k, v in jb.items() if k != "scene_ids"}
    jm = jg.GSPN(jcfg)
    idx = jops.farthest_point_sample(S, jx["xyz"], jx["valid"], impl="xla")
    gp, gv, _, _ = jinstances.gather_seed_instances(jx["xyz"], jx["inst_label"], idx, G)
    key = jax.random.PRNGKey(0)
    v = _perturbed(jax.jit(lambda x, f, s, val, p, pv: jm.init(
        key, x, s, features=f, valid=val, gt_points=p, gt_valid=pv, z_rng=key, train=False))(
            jx["xyz"], jx["features"], idx, jx["valid"], gp, gv), 11)
    rng = jax.random.PRNGKey(21)
    (_, (jmetrics, _)), jgrads = jax.jit(jax.value_and_grad(
        jsteps.make_gspn_loss_fn(jm, S, G), has_aux=True))(v["params"], v["batch_stats"], jx, rng)
    tm = tg.GSPN(gspn_config(jcfg), recognition=True)
    tm.load_state_dict(flax_to_state_dict(as_numpy_tree(v)), strict=True)
    z = t(jax.random.normal(jax.random.split(rng)[1], (B, S, jcfg.latent_dim), jnp.float32))
    total, metrics = tsteps.make_gspn_loss_fn(S, G)(tm.train(), to_device(tb, "cpu"), z_eps=z)
    total.backward()
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), **FWD,
                                   err_msg=k)
    want = flax_to_state_dict(as_numpy_tree({"params": jgrads}))
    bench_slice.assert_grads_close({k: p.grad for k, p in tm.named_parameters()}, want)


def test_stage2_first_step_on_partnet_parts_matches_jax(data, jax_plain):
    """The stage-2 loss and its terms on the first (Morton-sorted) PartNet
    batch, jittered GT boxes, with the JAX side's variables and jitter."""
    jb, tb = _first_batches(TINY + _flags("partnet_morton", data))
    jcfg = dataclasses.replace(jtrain2.tiny_rpointnet(18), ops_impl="xla")
    jx = {k: jnp.asarray(v) for k, v in jb.items()}
    boxes = jnp.tile(jnp.asarray([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0]], jnp.float32), (B, 8, 1))
    jm = jr.RPointNet(jcfg)
    v = _perturbed(jax.jit(lambda x, b, val: jm.init(
        jax.random.PRNGKey(0), x, b, valid=val, train=False))(jx["xyz"], boxes, jx["valid"]), 6)
    rng = jax.random.PRNGKey(7)
    _, (jmetrics, _) = jax.jit(jsteps.make_rpointnet_loss_fn(jm, I))(
        v["params"], v["batch_stats"], jx, rng)
    tm = tr.RPointNet(rpointnet_config(jcfg))
    tm.load_state_dict(flax_to_state_dict(as_numpy_tree(v)), strict=True)
    noise = t(jax.random.normal(jax.random.split(rng, 4)[0], (B, I, 6), jnp.float32))
    _, metrics = tsteps.make_rpointnet_loss_fn(I)(tm.train(), to_device(tb, "cpu"),
                                                  box_noise=noise)
    assert float(metrics["num_fg"]) > 0
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), **FWD,
                                   err_msg=k)


EVAL = TINY + ["--num-classes", "18", "--num-scenes", "5", "--score-thresh", "0"]


def test_run_eval_scannet_dumps_named_as_the_jax_eval(data, tmp_path, jax_plain):
    """``run_eval.main --scannet-dir --dump-format scannet``: each crop's
    dump named by its scan, a repeat draw of a scan ``<scene>__crop<k>``,
    the same names as the JAX eval's on the same files (the ragged last
    batch included); the dumps read back."""
    flags = EVAL + _flags("scannet_morton", data) + ["--dump-format", "scannet"]
    run_eval.main(CPU + flags + ["--dump-dir", str(tmp_path / "port")])
    with contextlib.redirect_stdout(io.StringIO()):
        jrun_eval.main(flags + ["--dump-dir", str(tmp_path / "jax")])
    names = sorted(p.name for p in (tmp_path / "port").glob("*.txt"))
    assert names == sorted(p.name for p in (tmp_path / "jax").glob("*.txt"))
    assert len(names) == 5 and any("__crop" in x for x in names), names
    assert all(x.startswith("scene000") for x in names)
    for txt in (tmp_path / "port").glob("*.txt"):
        for line in txt.read_text().splitlines():
            mask = tmp_path / "port" / line.split()[0]
            assert mask.exists() and 0 < len(mask.read_text().split()) <= NPTS  # valid points


def test_run_eval_partnet_morton(data, tmp_path):
    """``run_eval.main --partnet-dir --morton``: the AP summary over the
    part instances, and npz dumps named ``scene_<i>``."""
    res = run_eval.main(CPU + EVAL + _flags("partnet_morton", data) + [
        "--num-classes", "6", "--dump-dir", str(tmp_path)])
    assert {"ap", "ap_50", "per_class"} <= set(res)
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"scene_{i:05d}.npz" for i in range(5)]


def test_run_eval_data_dirs_are_mutually_exclusive():
    """``--scannet-dir`` with ``--partnet-dir`` fails at parse time with the
    JAX eval's message."""
    argv = ["--scannet-dir", "a", "--partnet-dir", "b"]
    errs = []
    for parse in (run_eval.parse_args, jrun_eval.parse_args):
        err = io.StringIO()
        with pytest.raises(SystemExit), contextlib.redirect_stderr(err):
            parse(argv)
        errs.append(err.getvalue().splitlines()[-1].split("error: ")[1])
    assert errs[0] == errs[1] == "--scannet-dir and --partnet-dir are mutually exclusive"


@pytest.mark.parametrize("entry,flag", [
    ("train_gspn", "--scannet-dir"), ("train_gspn", "--shapenet-dir"),
    ("train_gspn", "--partnet-dir"), ("train_rpointnet", "--scannet-dir"),
    ("train_rpointnet", "--partnet-dir"), ("run_eval", "--scannet-dir"),
    ("run_eval", "--partnet-dir"),
])
def test_data_dir_flags_read_their_directory(tmp_path, entry, flag):
    """Each data flag reads its directory: an empty one raises the loader's
    ``FileNotFoundError`` (no ``NotImplementedError``)."""
    main = {"train_gspn": ttrain.main, "train_rpointnet": ttrain2.main,
            "run_eval": run_eval.main}[entry]
    what = ".npz scenes" if flag == "--scannet-dir" else ".h5 files"
    with pytest.raises(FileNotFoundError, match=f"no {what} under"):
        main(CPU + TINY + [flag, str(tmp_path), "--log-dir", str(tmp_path / "run")]
             if entry != "run_eval" else CPU + TINY + [flag, str(tmp_path)])


def test_shapenet_category_reaches_the_loader(data):
    """``--shapenet-category`` filters the objects the trainer draws."""
    args = ttrain.parse_args(TINY + _flags("shapenet_category", data))
    batch = ttrain.make_sample_fn(args)(np.random.default_rng(0), 4)
    assert batch["xyz"].shape == (4, NPTS, 3)
    with pytest.raises(ValueError, match="no objects"):
        ttrain.make_sample_fn(ttrain.parse_args(TINY + ["--shapenet-dir", data["shapenet"],
                                                        "--shapenet-category", "99"]))
    assert torch.equal(torch.as_tensor(batch["inst_label"]), torch.ones(4, NPTS, dtype=torch.int32))
