"""The port's inference slice end to end (``gspn_tpu_torch.models.pipeline``)
against the JAX package's ``make_inference_fn`` on the TINY pipeline (its
default ``mask_project="1nn"``, plus the box-pruned, grid-RoI and "3nn"
variants), weights carried across by ``gspn_tpu_torch.convert``, and the
CVAE noise the JAX ``infer`` draws from ``PRNGKey(1)``. Masks, valid and
classes must be equal; scores and boxes within the fixtures' tolerances
(``tests/test_fixtures.py``). Plus the package's boundaries: no JAX import,
no kernel launch on the CPU, a model runs only its own config, every flag
of the JAX package's entry points and every name its subpackages export
are the port's too, and the synthetic scenes equal the JAX package's. The
"strided_select" case runs ``group_select="strided"`` in both stages."""

import argparse
import dataclasses
import importlib
import importlib.util
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gspn_tpu.data import synthetic as jsynthetic
from gspn_tpu.models import pipeline as jpl
from gspn_tpu.models.presets import set_pipeline_fps_segments, set_pipeline_group_select
from gspn_tpu_torch import convert, ops
from gspn_tpu_torch.data import synthetic as tsynthetic
from gspn_tpu_torch.models import pipeline as tpl
from gspn_tpu_torch.models import presets as tpresets
from gspn_tpu_torch.utils import bench_slice
from tests.test_fixtures import _base_pipeline_variables, _load
from tests.test_pipeline_eval import TINY
from tests.torch_parity import as_numpy_tree, n, pipeline_config, t

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY_3NN = dataclasses.replace(TINY, mask_project="3nn")


def _spatial(cfg):
    return set_pipeline_fps_segments(dataclasses.replace(cfg, num_seeds=16), 2, "spatial")


def _cases():
    """Configs under test. ``mask_thresh`` sits inside the range of the mask
    logits the fixture's weights give (about -0.23..-0.04), so that masks
    hold points on both sides of the threshold and their comparison is not
    vacuous (at 0.5 every mask is empty, the frozen fixture's included)."""
    tiny = dataclasses.replace(TINY, mask_thresh=0.47)
    return {
        "exact_fps": tiny,
        "spatial_fps": _spatial(tiny),
        "strided_fps": set_pipeline_fps_segments(
            dataclasses.replace(tiny, num_seeds=16), 2, "strided"
        ),
        "pruned_spatial": dataclasses.replace(_spatial(tiny), mask_project_prune="auto"),
        "grid_roi": dataclasses.replace(  # grid samples' logits lie lower
            tiny, mask_thresh=0.455,
            rpointnet=dataclasses.replace(tiny.rpointnet, roi_sample="grid"),
        ),
        "exact_fps_3nn": dataclasses.replace(TINY_3NN, mask_thresh=0.47),
        "strided_select": set_pipeline_group_select(tiny, "strided"),
        # sa1 in a pass of its own at 4 segments: both passes spatial on one
        # Morton sort, or two contiguous passes over the input
        "sa1_split_spatial": dataclasses.replace(_spatial(tiny), sa1_fps_segments=4),
        "sa1_split_contiguous": dataclasses.replace(set_pipeline_fps_segments(
            dataclasses.replace(tiny, num_seeds=16), 2, "contiguous"), sa1_fps_segments=4),
    }


def _inputs(case):
    """(xyz, valid, JAX variables): the frozen fixture's weights, on its
    scenes or (strided case) on other synthetic scenes."""
    z = _load("instance_inference.npz")
    if case != "strided_fps":
        return z["in/xyz"], z["in/valid"], _base_pipeline_variables(z)
    sb = jsynthetic.scene_batch(
        np.random.default_rng(5), 2, n_points=192, max_instances=3, extent=2.0
    )
    return sb["xyz"], sb["valid"], _base_pipeline_variables(z)


def _port_model(cfg, variables):
    model = tpl.PipelineModel(cfg)
    model.load_state_dict(convert.pipeline_state_dict(as_numpy_tree(variables)))
    return model.eval()


@pytest.mark.parametrize(
    "case",
    ["exact_fps", "spatial_fps", "strided_fps", "pruned_spatial", "grid_roi", "exact_fps_3nn",
     "strided_select", "sa1_split_spatial", "sa1_split_contiguous"],
)
def test_slice_matches_jax_make_inference_fn(case, monkeypatch):
    jcfg = _cases()[case]
    xyz, valid, variables = _inputs(case)
    want = jpl.make_inference_fn(jcfg)(
        variables, jnp.asarray(xyz), None, jnp.asarray(valid), jax.random.PRNGKey(1)
    )
    if case == "strided_select":  # the scenes' balls and boxes overflow K: selection differs
        first = jpl.make_inference_fn(_cases()["exact_fps"])(
            variables, jnp.asarray(xyz), None, jnp.asarray(valid), jax.random.PRNGKey(1)
        )
        assert not np.array_equal(np.asarray(want.scores), np.asarray(first.scores))
    # exactly the noise the JAX infer draws from PRNGKey(1) (gspn.py:230)
    eps = np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), (xyz.shape[0], jcfg.num_seeds, jcfg.gspn.latent_dim),
        jnp.float32,
    ))
    cfg = pipeline_config(jcfg)
    sorts, fps_calls = [], []
    for name, sink in (("spatial_sorted_view", sorts), ("farthest_point_sample", fps_calls)):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _s=sink, **k: _s.append(a[0]) or _r(
            *a, **k))
    with torch.inference_mode():
        got = tpl.make_inference_fn(cfg)(
            _port_model(cfg, variables), t(xyz), t(valid), z_eps=t(eps)
        )
    if case.startswith("sa1_split"):  # the seeds' pass and sa1's, then SA2
        assert fps_calls == [16, 32, 8] and len(sorts) == (case == "sa1_split_spatial")
    for f in ("masks", "valid", "classes"):
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(want, f)))
    for f in ("scores", "boxes"):
        np.testing.assert_allclose(
            n(getattr(got, f)), np.asarray(getattr(want, f)), rtol=1e-4, atol=1e-5
        )
    m = n(got.masks)[n(got.valid)]
    assert m.any() and not m.all()  # the masks comparison sees both outcomes
    assert got.classes.dtype == torch.int32 and got.masks.dtype == torch.bool


def test_cpu_calls_launch_no_kernel():
    z = _load("instance_inference.npz")
    ops.reset_launch_counts()
    for case in ("spatial_fps", "pruned_spatial", "grid_roi", "exact_fps_3nn", "strided_select"):
        cfg = pipeline_config(_cases()[case])
        model = _port_model(cfg, _base_pipeline_variables(z))
        out = tpl.make_inference_fn(cfg)(
            model, t(z["in/xyz"]), t(z["in/valid"]), generator=torch.Generator().manual_seed(0)
        )
        assert out.masks.shape == (2, cfg.num_seeds, 128)
    assert set(ops.launch_counts()) == set(ops.KERNELS) and len(ops.KERNELS) == 19
    assert all(c == 0 for c in ops.launch_counts().values()), ops.launch_counts()


def test_infer_refuses_a_model_built_from_another_config():
    """The plain path must be plain: a model keeps the ``ops_impl`` it was
    built with, so running it under another config's ``infer`` raises."""
    z = _load("instance_inference.npz")
    cfg = pipeline_config(TINY)
    model = _port_model(cfg, _base_pipeline_variables(z))
    pcfg = bench_slice.plain_config(cfg)
    with pytest.raises(ValueError, match="other stage configs"):
        tpl.make_inference_fn(pcfg)(model, t(z["in/xyz"]), t(z["in/valid"]),
                                    generator=torch.Generator().manual_seed(0))
    _, pmodel = bench_slice.plain_model(pcfg, model)
    assert pmodel.rpointnet.config == pcfg.rpointnet and pmodel.gspn.config == pcfg.gspn
    assert pmodel.rpointnet.backbone.sa1.ops_impl == "plain"
    out = tpl.make_inference_fn(pcfg)(pmodel, t(z["in/xyz"]), t(z["in/valid"]),
                                      generator=torch.Generator().manual_seed(0))
    assert out.masks.shape == (2, cfg.num_seeds, 128)


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gspn_tpu_torch\n"
        "for m in pkgutil.walk_packages(gspn_tpu_torch.__path__, 'gspn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'gspn_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'gspn_tpu_torch.eval.run_eval' in sys.modules\n"
        "print(len([m for m in sys.modules if m.startswith('gspn_tpu_torch')]))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15  # every module was imported


def _knobbed(knob, stage="gspn"):
    cfg = pipeline_config(TINY)
    (key, value), = knob.items()
    if key in ("group_select", "dtype", "feature_dim"):
        return dataclasses.replace(
            cfg, **{stage: dataclasses.replace(getattr(cfg, stage), **knob)})
    return dataclasses.replace(cfg, **knob)


def test_unported_ops_raise():
    """Every op-level selection is ported: an unknown ``select`` is a
    ``ValueError``, as in the JAX package."""
    with pytest.raises(ValueError, match="first|strided"):
        ops.query_ball_group_multi(
            (0.1,), (4,), torch.zeros(1, 8, 3), torch.zeros(1, 2, 3), select="middle"
        )


@pytest.mark.parametrize("stage", ["gspn", "rpointnet"])
def test_unknown_group_select_raises_value_error(stage):
    with pytest.raises(ValueError, match="group_select must be first|strided"):
        tpl.make_inference_fn(_knobbed({"group_select": "middle"}, stage))
    tpl.make_inference_fn(_knobbed({"group_select": "strided"}, stage))  # ported


# the JAX package's entry points and the port's counterparts: (module or
# script path, the port's module), each a ``main(argv)`` that parses first
ENTRY_POINTS = {
    "train_gspn": ("gspn_tpu.train.train_gspn", "gspn_tpu_torch.train.train_gspn"),
    "train_rpointnet": ("gspn_tpu.train.train_rpointnet",
                        "gspn_tpu_torch.train.train_rpointnet"),
    "run_eval": ("gspn_tpu.eval.run_eval", "gspn_tpu_torch.eval.run_eval"),
    "export_serving": ("scripts/export_serving.py", "gspn_tpu_torch.serve.export_serving"),
    "serve_gspnx": ("scripts/serve_gspnx.py", "gspn_tpu_torch.serve.serve_gspnx"),
    "preprocess_scannet": ("scripts/preprocess_scannet.py",
                           "gspn_tpu_torch.data.preprocess_scannet"),
    "demo_predict": ("scripts/demo_predict.py", "gspn_tpu_torch.eval.demo_predict"),
}
# ROADMAP.md's "do not carry" names of the JAX package's exports: none since
# the timer (``utils/timing.py``: ``sync``, ``time_fn``) was ported
NOT_CARRIED: dict[str, set[str]] = {}


class _Parsed(Exception):
    """Raised by the patched ``parse_args`` with the parser it was called on."""


def _entry_module(name: str):
    if not name.endswith(".py"):
        return importlib.import_module(name)
    spec = importlib.util.spec_from_file_location(f"jax_script_{pathlib.Path(name).stem}",
                                                  REPO / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _flags(module, monkeypatch) -> set[str]:
    """The option strings (and positional names) of the parser ``module``'s
    ``main`` builds, caught at its ``parse_args`` call (some scripts build
    the parser inside ``main``)."""
    def capture(self, *args, **kwargs):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed) as caught:
            module.main([])
    return {s for a in caught.value.args[0]._actions for s in (a.option_strings or [a.dest])}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_port_entry_points_take_every_jax_flag(entry, monkeypatch):
    """Every flag of the JAX package's entry point is one of its port's
    (which may add ``--device``): nothing a user passes the JAX command is
    missing from the port's."""
    jax_name, port_name = ENTRY_POINTS[entry]
    want = _flags(_entry_module(jax_name), monkeypatch)
    got = _flags(importlib.import_module(port_name), monkeypatch)
    assert len(want) > 2 and want <= got, sorted(want - got)


def _exports(package) -> set[str]:
    names = getattr(package, "__all__", None)
    if names is None:  # no __all__: what the __init__ imports
        names = [k for k, v in vars(package).items()
                 if not k.startswith("_") and not isinstance(v, types.ModuleType)]
    return set(names)


@pytest.mark.parametrize("sub", sorted(p.parent.name for p in (REPO / "gspn_tpu").glob(
    "*/__init__.py")))
def test_port_exports_every_jax_name(sub):
    """Every name a ``gspn_tpu`` subpackage exports, ``gspn_tpu_torch``'s
    counterpart exports too, but ROADMAP.md's "do not carry" names; and
    each resolves."""
    want = _exports(importlib.import_module(f"gspn_tpu.{sub}")) - NOT_CARRIED.get(sub, set())
    port = importlib.import_module(f"gspn_tpu_torch.{sub}")
    assert want <= _exports(port), sorted(want - _exports(port))
    for name in want:
        assert getattr(port, name) is not None, name
    assert not any("not_ported" in path.read_text()
                   for path in (REPO / "gspn_tpu_torch" / sub).rglob("*.py"))


@pytest.mark.parametrize(
    "knob", [{"mask_project": "2nn"}, {"mask_project_prune": "on"}], ids=lambda k: next(iter(k))
)
def test_unknown_knob_values_raise_value_error(knob):
    with pytest.raises(ValueError, match="must be"):
        tpl.make_inference_fn(dataclasses.replace(pipeline_config(TINY), **knob))


def test_variants_take_the_same_weights():
    """The prune, grid, 3nn and strided configs need no new converter parameter: the
    JAX variables of each variant have the slice's tree, and they load
    strictly into the port's model of every variant."""
    trees = {}
    for name, jcfg in _cases().items():
        jv = jax.eval_shape(
            lambda c=jcfg: jpl.init_pipeline_variables(c, jax.random.PRNGKey(0), 64))
        trees[name] = jax.tree_util.tree_map(lambda s: (s.shape, s.dtype), jv)
        conv = convert.pipeline_state_dict(
            jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), jv))
        tpl.PipelineModel(pipeline_config(jcfg)).load_state_dict(conv, strict=True)
    assert all(tr == trees["exact_fps"] for tr in trees.values())
    base = tpl.init_pipeline_variables(
        bench_slice.slice_config(), torch.Generator().manual_seed(0), 1024)
    for name in bench_slice.VARIANTS:
        sd = tpl.init_pipeline_variables(
            bench_slice.variant_config(name), torch.Generator().manual_seed(0), 1024)
        assert sd.keys() == base.keys() and all(torch.equal(sd[k], base[k]) for k in sd)


@pytest.mark.parametrize(
    "kw",
    [
        dict(n_points=192, max_instances=3, extent=2.0),
        dict(n_points=1000, max_instances=24, extent=8.0),
        dict(n_points=64, max_instances=8, bg_frac=0.5),
        dict(n_points=64, feature_dim=3),
    ] + [dict(jsynthetic.FAMILIES[f], n_points=192) for f in sorted(jsynthetic.FAMILIES)]
    + [dict(jsynthetic.FAMILIES[f], n_points=40) for f in ("uniform", "sparse")],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()),
)
def test_scene_batch_matches_jax_package(kw):
    """Bitwise the JAX package's scenes, every generator family (run_eval
    ``--family``) included; 40 points shrink the area families' instances."""
    assert tsynthetic.FAMILIES == jsynthetic.FAMILIES
    a = tsynthetic.scene_batch(np.random.default_rng(0), 3, **kw)
    b = jsynthetic.scene_batch(np.random.default_rng(0), 3, **kw)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_init_pipeline_variables_matches_jax_tree():
    """Seeded init: reproducible, Flax's init values for BatchNorm and biases,
    and the same names and shapes as converted JAX variables."""
    cfg = tpresets.scannet_pipeline()
    sd = tpl.init_pipeline_variables(cfg, torch.Generator().manual_seed(0), 1024)
    again = tpl.init_pipeline_variables(cfg, torch.Generator().manual_seed(0), 1024)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    jv = jax.eval_shape(
        lambda: jpl.init_pipeline_variables(
            jpl.PipelineConfig(gspn=TINY.gspn, rpointnet=TINY.rpointnet, num_seeds=12),
            jax.random.PRNGKey(0), 64,
        )
    )
    tiny = tpl.init_pipeline_variables(
        pipeline_config(TINY_3NN), torch.Generator().manual_seed(0), 64
    )
    conv = convert.pipeline_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), jv)
    )
    assert {k: tuple(v.shape) for k, v in conv.items()} == {
        k: tuple(v.shape) for k, v in tiny.items()
    }
    for k, v in sd.items():
        if k.endswith((".bias", ".mean")):
            assert not v.any(), k
        elif k.endswith((".scale", ".var")):
            assert (v == 1).all(), k
        else:
            fan_out, fan_in = v.shape
            assert v.abs().max() <= (6.0 / (fan_in + fan_out)) ** 0.5


@pytest.mark.parametrize("shape", list(bench_slice.SHAPES))
def test_bench_slice_requests(shape):
    """The measured slice's inputs: the bench's scenes (``bench.py`` builds
    them from the JAX package's generator, padding the whole scene's tail),
    seeded noise, and a config the port runs."""
    b, n_pts, kw, pad = bench_slice.SHAPES[shape]
    cfg = bench_slice.slice_config()
    tpl.check_supported(cfg)
    xyz, valid, eps = bench_slice.request(cfg, shape, torch.device("cpu"), seed=1)
    want = jsynthetic.scene_batch(np.random.default_rng(0), b, n_points=n_pts, **kw)
    want_valid = want["valid"].copy()
    if pad:
        want_valid[:, -n_pts // 10:] = False
    np.testing.assert_array_equal(n(xyz), want["xyz"])
    np.testing.assert_array_equal(n(valid), want_valid)
    assert eps.shape == (b, cfg.num_seeds, cfg.gspn.latent_dim)
    assert torch.equal(eps, bench_slice.request(cfg, shape, torch.device("cpu"), seed=1)[2])


def _stream(z, t_steps=3):
    """``(xyz_s, valid_s)`` of ``t_steps`` batches: the fixture's scenes, their
    points reversed, and scaled by 0.9."""
    xyz, valid = z["in/xyz"], z["in/valid"]
    xs = [xyz, xyz[:, ::-1], xyz * np.float32(0.9)][:t_steps]
    vs = [valid, valid[:, ::-1], valid][:t_steps]
    return np.ascontiguousarray(np.stack(xs)), np.ascontiguousarray(np.stack(vs))


def test_streamed_inference_equals_separate_calls():
    """``make_streamed_inference_fn`` on T=3 batches (on the CPU a loop) is
    the T separate ``infer`` calls, bit for bit, batch t with noise t."""
    z = _load("instance_inference.npz")
    cfg = pipeline_config(_cases()["spatial_fps"])
    model = _port_model(cfg, _base_pipeline_variables(z))
    xyz_s, valid_s = _stream(z)
    eps_s = torch.randn((3, xyz_s.shape[1], cfg.num_seeds, cfg.gspn.latent_dim),
                        generator=torch.Generator().manual_seed(0))
    infer = tpl.make_inference_fn(cfg)
    with torch.inference_mode():
        got = tpl.make_streamed_inference_fn(cfg)(model, t(xyz_s), t(valid_s), eps_s)
        for step in range(3):
            want = infer(model, t(xyz_s[step]), t(valid_s[step]), z_eps=eps_s[step])
            for f in tpl.PREDICTION_FIELDS:
                assert torch.equal(getattr(got, f)[step], getattr(want, f)), (f, step)
    assert got.masks.shape == (3, xyz_s.shape[1], cfg.num_seeds, xyz_s.shape[2])


def test_streamed_inference_matches_jax():
    """Against the JAX package's ``make_streamed_inference_fn`` (one
    ``lax.scan``) with the noise its step t draws from ``rngs[t]``."""
    z = _load("instance_inference.npz")
    jcfg = _cases()["exact_fps"]
    variables = _base_pipeline_variables(z)
    xyz_s, valid_s = _stream(z)
    rngs = jax.random.split(jax.random.PRNGKey(3), 3)
    want = jpl.make_streamed_inference_fn(jcfg)(variables, jnp.asarray(xyz_s),
                                                jnp.asarray(valid_s), rngs)
    eps_s = np.stack([np.asarray(jax.random.normal(
        k, (xyz_s.shape[1], jcfg.num_seeds, jcfg.gspn.latent_dim), jnp.float32)) for k in rngs])
    cfg = pipeline_config(jcfg)
    with torch.inference_mode():
        got = tpl.make_streamed_inference_fn(cfg)(_port_model(cfg, variables), t(xyz_s),
                                                  t(valid_s), t(eps_s))
    for f in ("masks", "valid", "classes"):
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(want, f)), f)
    for f in ("scores", "boxes"):
        np.testing.assert_allclose(n(getattr(got, f)), np.asarray(getattr(want, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    m = n(got.masks)[n(got.valid)]
    assert m.any() and not m.all()


@pytest.mark.parametrize("fixture", ["instance_inference", "inference_segfps",
                                     "inference_segfps_spatial", "inference_width2",
                                     "inference_bf16"])
def test_slice_matches_frozen_fixture(fixture):
    """The port against the frozen outputs ``scripts/make_fixtures.py``
    wrote (TINY at its own thresholds; the segmented cases at 16 seeds and
    S=2), on the fixture's weights and scenes with the noise it drew,
    ``PRNGKey(1)``: masks, valid and classes equal, scores and boxes within
    the fixtures' tolerances (``tests/test_fixtures.py``: 2e-2 for bf16).
    The width-2 case runs ``scale_pipeline_widths(TINY, 2)`` on that
    fixture's own weights; the bf16 case ``set_pipeline_dtype(TINY,
    bfloat16)`` on the base weights."""
    base = _load("instance_inference.npz")
    frozen = _load(f"{fixture}.npz")
    cfg = pipeline_config(TINY)
    weights = base
    if fixture == "inference_width2":
        cfg, weights = tpresets.scale_pipeline_widths(cfg, 2), frozen
    elif fixture == "inference_bf16":
        cfg = tpresets.set_pipeline_dtype(cfg, torch.bfloat16)
    elif fixture != "instance_inference":
        mode = "spatial" if fixture.endswith("spatial") else "contiguous"
        cfg = tpresets.set_pipeline_fps_segments(dataclasses.replace(cfg, num_seeds=16), 2, mode)
    xyz, valid = base["in/xyz"], base["in/valid"]
    eps = np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), (xyz.shape[0], cfg.num_seeds, cfg.gspn.latent_dim), jnp.float32))
    with torch.inference_mode():
        got = tpl.make_inference_fn(cfg)(_port_model(cfg, _base_pipeline_variables(weights)),
                                         t(xyz), t(valid), z_eps=t(eps))
    for f in ("masks", "valid", "classes"):
        np.testing.assert_array_equal(n(getattr(got, f)), frozen[f"out/{f}"], f)
    tol = 2e-2 if fixture == "inference_bf16" else None
    for f in ("scores", "boxes"):
        np.testing.assert_allclose(n(getattr(got, f)), frozen[f"out/{f}"], rtol=tol or 1e-4,
                                   atol=tol or 1e-5, err_msg=f)
    assert frozen["out/valid"].any()
