"""The port's ``utils`` modules that had stayed TPU-only against the JAX
package's, on the CPU: the roofline model (``utils/roofline.py``) stage by
stage for the configs the port measures, its floors on the H100's peaks,
the timer (``utils/timing.py``), and the debugging aids
(``utils/debug.py``); with ``utils/profile_roofline.py``, which prints the
model's floors, and the faults checked before each slice: the port and
``chip_smoke.py`` import nothing of JAX, and every entry point that runs
on the card defaults to ``--device cuda``.

The model is arithmetic over the same formulas and integer shapes, so the
port's costs equal the JAX package's within rtol 1e-12 (the sums are taken
in the same order; one builder, ``chamfer_cost``, groups a product
otherwise).
"""

import argparse
import ast
import dataclasses
import importlib
import itertools
import os
import pathlib
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gspn_tpu.models import presets as jpresets
from gspn_tpu.models.gspn import GSPNConfig as JGSPNConfig
from gspn_tpu.models.gspn import shapenet_config as jshapenet_config
from gspn_tpu.models.pipeline import PipelineConfig as JPipelineConfig
from gspn_tpu.models.rpointnet import RPointNetConfig as JRPointNetConfig
from gspn_tpu.utils import roofline as jrf
from gspn_tpu.utils import timing as jtiming
from gspn_tpu.utils.debug import checked as jchecked
from gspn_tpu_torch import ops
from gspn_tpu_torch.ops import common
from gspn_tpu_torch.utils import debug, profile_roofline, timing
from gspn_tpu_torch.utils import roofline as rf

REPO = pathlib.Path(__file__).resolve().parent.parent
FIELDS = ("mxu_flops", "vpu_ops", "hbm_bytes")


def _jax_config(stage: str, preset: str, n: int, width_mult: int, dtype: str):
    """The JAX package's counterpart of ``profile_roofline.pipeline_config``."""
    if preset == "object":
        cfg = JPipelineConfig(gspn=jshapenet_config(n, num_gen_points=512),
                              rpointnet=JRPointNetConfig(), num_seeds=64)
    elif stage == "1":
        cfg = JPipelineConfig(gspn=JGSPNConfig(), rpointnet=JRPointNetConfig(), num_seeds=64)
    else:
        exact = stage == "2" or preset == "exact"
        cfg = jpresets.scannet_pipeline(num_seeds=64, **({"fps_segments": 1} if exact else {}))
    if width_mult != 1:
        cfg = jpresets.scale_pipeline_widths(cfg, width_mult)
    if dtype == "bf16":
        cfg = jpresets.set_pipeline_dtype(cfg, jnp.bfloat16)
    return cfg


def _assert_same_stages(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for name, c in want.items():
        for f in FIELDS:
            np.testing.assert_allclose(getattr(got[name], f), getattr(c, f), rtol=1e-12,
                                       atol=0, err_msg=f"{name}.{f}")


# (stage, preset, B, N, width, dtype): the bench's two request shapes, the
# exact FPS, the object preset, --width-mult 2 and bf16
PIPELINES = {
    "scannet-B8xN8192": ("infer", "scannet", 8, 8192, 1, "f32"),
    "scannet-B1xN65536": ("infer", "scannet", 1, 65536, 1, "f32"),
    "exact-B8xN8192": ("infer", "exact", 8, 8192, 1, "f32"),
    "object-B4xN4096": ("infer", "object", 4, 4096, 1, "f32"),
    "scannet-x2": ("infer", "scannet", 8, 8192, 2, "f32"),
    "scannet-bf16": ("infer", "scannet", 8, 8192, 1, "bf16"),
}


@pytest.mark.parametrize("case", list(PIPELINES))
def test_pipeline_cost_equals_jax(case):
    stage, preset, b, n, width, dtype = PIPELINES[case]
    cfg = profile_roofline.pipeline_config(stage, preset, n, width, dtype)
    jcfg = _jax_config(stage, preset, n, width, dtype)
    _assert_same_stages(rf.pipeline_cost(cfg, b, n), jrf.pipeline_cost(jcfg, b, n))


# slice (G): stage 1 at train_gspn's defaults; slice (I): stage 2 at
# bench_slice.stage2_configs(); both B=4 x N=4096, and wide, bf16, object
STEPS = {
    "stage1-G": ("1", "scannet", 1, "f32"),
    "stage2-I": ("2", "scannet", 1, "f32"),
    "stage1-x2-bf16": ("1", "scannet", 2, "bf16"),
    "stage2-x2": ("2", "scannet", 2, "f32"),
    "stage1-object": ("1", "object", 1, "f32"),
}


@pytest.mark.parametrize("case", list(STEPS))
def test_train_step_cost_equals_jax(case):
    stage, preset, width, dtype = STEPS[case]
    cfg = profile_roofline.pipeline_config(stage, preset, 4096, width, dtype)
    jcfg = _jax_config(stage, preset, 4096, width, dtype)
    _assert_same_stages(rf.train_step_cost(cfg, 4, 4096, gt_size=256, stage=int(stage)),
                        jrf.train_step_cost(jcfg, 4, 4096, gt_size=256, stage=int(stage)))


def test_stage2_config_is_bench_slices():
    from gspn_tpu_torch.utils import bench_slice

    cfg = profile_roofline.pipeline_config("2")
    assert (cfg.gspn, cfg.rpointnet) == bench_slice.stage2_configs()
    assert profile_roofline.pipeline_config("1").gspn == bench_slice.train_config()


def test_h100_peaks():
    """The card's peaks (NVIDIA's H100 SXM data sheet, dense, 700 W), the
    rates ``chip_smoke.py``'s bounds divide by, and no TPU number."""
    assert (rf.H100_SXM.mxu_flops, rf.H100_SXM.vpu_ops, rf.H100_SXM.hbm_bytes) == (
        67e12, 33.5e12, 3.35e12)
    assert (rf.H100_SXM_BF16.mxu_flops, rf.H100_SXM_BF16.vpu_ops,
            rf.H100_SXM_BF16.hbm_bytes) == (989e12, 33.5e12, 3.35e12)
    assert not hasattr(rf, "V5E")
    text = (REPO / "gspn_tpu_torch/utils/roofline.py").read_text()
    assert "v5e" not in text.lower() and "819" not in text and "197e12" not in text


# the counterparts of tests/test_roofline.py, on the H100's peaks


def test_cost_addition_and_floors():
    a = rf.Cost(mxu_flops=1e12, vpu_ops=1e10, hbm_bytes=1e9)
    c = a + rf.Cost(vpu_ops=3e10)
    assert c.mxu_flops == 1e12 and c.vpu_ops == 4e10 and c.hbm_bytes == 1e9
    f = c.floors(rf.H100_SXM)
    assert set(f) == {"mxu", "vpu", "hbm", "floor", "bound"}
    assert f["floor"] == max(f["mxu"], f["vpu"], f["hbm"])
    assert f == c.floors()  # H100_SXM is the default
    assert f["mxu"] == 1e12 / 67e12 and f["bound"] == "mxu"


def test_report_fractions():
    c = rf.Cost(mxu_flops=rf.H100_SXM.mxu_flops)  # exactly 1 second of matmul
    rep = c.report(2.0)
    assert np.isclose(rep["mfu"], 0.5)
    assert np.isclose(rep["frac_of_roof"], 0.5)
    assert rep["bound"] == "mxu"
    bf16 = c.report(2.0, rf.H100_SXM_BF16)
    assert np.isclose(bf16["mfu"], 0.5 * 67 / 989)
    assert c.report(0.0)["mfu"] == 0.0


def test_mlp_cost_formula():
    c = rf.mlp_cost(rows=100, cin=3, widths=(8, 16))
    assert c.mxu_flops == 2 * 100 * (3 * 8 + 8 * 16)
    assert c.hbm_bytes == 100 * (3 + 16) * 4


def test_fp_cost_pairing_matches_model():
    """fp_mlps[0] runs at the deepest target level, fp_mlps[-1] at the N
    points with the previous FP's output as its source channels."""
    cfg = profile_roofline.pipeline_config()
    r = cfg.rpointnet
    b, n = 1, 8192
    stages = rf.pipeline_cost(cfg, b=b, n=n)
    src_c = r.fp_mlps[-2][-1]
    expect = (rf.three_nn_cost(b, n, r.sa_layers[0].npoint)
              + rf.interpolate_mm_cost(b, n, r.sa_layers[0].npoint, src_c)
              + rf.mlp_cost(b * n, src_c + 3, r.fp_mlps[-1]))
    got = stages[f"fp{len(r.fp_mlps)}"]
    assert np.isclose(got.mxu_flops, expect.mxu_flops)
    assert np.isclose(got.vpu_ops, expect.vpu_ops)
    nsa = len(r.sa_layers)
    tgt1, src1 = r.sa_layers[nsa - 2].npoint, r.sa_layers[nsa - 1].npoint
    expect1 = (rf.three_nn_cost(b, tgt1, src1)
               + rf.interpolate_mm_cost(b, tgt1, src1, r.sa_layers[-1].mlp[-1])
               + rf.mlp_cost(b * tgt1, r.sa_layers[-1].mlp[-1] + r.sa_layers[nsa - 2].mlp[-1],
                             r.fp_mlps[0]))
    assert np.isclose(stages["fp1"].mxu_flops, expect1.mxu_flops)


def test_train_step_cost_structure():
    """Both stages: non-negative, additive, a floor of 10 us to 10 ms on
    the card, and a stage-2 step costs more than the request it trains."""
    cfg = profile_roofline.pipeline_config("2")
    infer = rf.pipeline_cost(cfg, b=4, n=4096)
    for stage in (1, 2):
        stages = rf.train_step_cost(cfg, b=4, n=4096, gt_size=256, stage=stage)
        assert "total" in stages and "adam" in stages
        partial = rf.Cost()
        for k, v in stages.items():
            assert v.mxu_flops >= 0 and v.vpu_ops >= 0 and v.hbm_bytes >= 0, k
            if k != "total":
                partial = partial + v
        assert np.isclose(partial.vpu_ops, stages["total"].vpu_ops)
        assert 1e-5 < stages["total"].floors()["floor"] < 1e-2
    s2 = rf.train_step_cost(cfg, b=4, n=4096, stage=2)["total"]
    assert s2.mxu_flops > infer["total"].mxu_flops


def test_pipeline_cost_structure():
    stages = rf.pipeline_cost(profile_roofline.pipeline_config(), b=8, n=8192)
    assert "total" in stages and "fps(shared seeds+sa1)" in stages
    partial = rf.Cost()
    for k, v in stages.items():
        assert v.mxu_flops >= 0 and v.vpu_ops >= 0 and v.hbm_bytes >= 0
        if k != "total":
            assert v.vpu_ops + v.mxu_flops > 0, k
            partial = partial + v
    for f in FIELDS:
        assert np.isclose(getattr(partial, f), getattr(stages["total"], f))
    # B=8 x N=8192 on the card: under 10 ms, above 100 us
    assert 1e-4 < stages["total"].floors()["floor"] < 1e-2


def test_kernel_cost_takes_the_cases_layout():
    """``profile_roofline.kernel_cost`` reads each kernel's arguments as
    ``time_kernels.cases`` lays them out and gives the model's builder."""
    xyz, q = torch.zeros(2, 100, 3), torch.zeros(2, 10, 3)
    boxes, src = torch.zeros(2, 5, 6), torch.zeros(2, 20, 3)
    feats, idx = torch.zeros(2, 20, 7), torch.zeros(2, 100, 3, dtype=torch.int32)
    want = {
        ("fps", (16, xyz, None)): rf.fps_cost(2, 100, 16),
        ("ball_group_strided", ((0.1, 0.2), (8, 16), xyz, q, None)):
            rf.ball_group_cost(2, 10, 100, (8, 16)),
        ("ball_query", ((0.1,), (8,), xyz, q, None)): rf.ball_group_cost(2, 10, 100, (8,)),
        ("box_group", (boxes, 32, xyz, None)): rf.ball_group_cost(2, 5, 100, (32,)),
        ("three_nn", (xyz, src, None)): rf.three_nn_cost(2, 100, 20),
        ("interp_mm", (feats, idx, torch.zeros(2, 100, 3), None)):
            rf.interpolate_mm_cost(2, 100, 20, 7),
        ("mask_project", (xyz, torch.zeros(2, 5, 4, 3), torch.zeros(2, 5, 4))):
            rf.mask_project_cost(2, 5, 100, 4),
        ("nms", (boxes, torch.zeros(2, 5), 0.25)): rf.nms_cost(2, 5),
        ("nn_argmin", (xyz, src, None, None)): rf.chamfer_cost(2, 100, 20),
        ("index_add", (feats, torch.zeros(2, 20, dtype=torch.int32), 9)):
            rf.gather_cost(40, 7),
    }
    for (name, args), cost in want.items():
        assert profile_roofline.kernel_cost(name, args) == cost, name
    with pytest.raises(ValueError, match="no model cost"):
        profile_roofline.kernel_cost("not_a_kernel", ())


def test_profile_roofline_prints_floors_and_refuses_to_measure_without_a_card(capsys):
    profile_roofline.main(["--stage", "2", "--dtype", "bf16"])
    out = capsys.readouterr().out
    assert "bfloat16 tensor cores" in out and "frozen gspn fwd" in out
    assert out.strip().splitlines()[-1].startswith("total")
    if torch.cuda.is_available():
        pytest.skip("a card is present: --measure would run")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        profile_roofline.main(["--measure"])


# timing


def _fake_clock(monkeypatch, module, durations):
    """Each call of the returned fn advances ``module``'s clock by the next
    of ``durations``."""
    now, it = [0.0], iter(durations)
    monkeypatch.setattr(module, "time", types.SimpleNamespace(perf_counter=lambda: now[0]))

    def advance():
        now[0] += next(it)
    return advance


# a warm-up call, then three blocks of two calls: block means 1, 6 and 2 s
DURATIONS = [100.0, 1.0, 1.0, 6.0, 6.0, 2.0, 2.0]


@pytest.mark.parametrize("stat,want", [("mean", 3.0), ("median", 2.0), ("min", 1.0)])
def test_time_fn_stat_and_batches_as_jax(monkeypatch, stat, want):
    advance = _fake_clock(monkeypatch, timing, DURATIONS)

    def fn(x):
        advance()
        return {"out": [x * 2]}

    got = timing.time_fn(fn, torch.ones(3), iters=2, warmup=1, batches=3, stat=stat)
    jadvance = _fake_clock(monkeypatch, jtiming, DURATIONS)

    def jfn(x):
        jadvance()
        return x * 2

    assert got == want == jtiming.time_fn(jfn, jnp.ones(3), iters=2, warmup=1, batches=3,
                                          stat=stat)


def test_time_fn_defaults_and_sync():
    calls = []
    assert timing.time_fn(lambda: calls.append(1) or torch.zeros(1)) >= 0.0
    assert len(calls) == 2 + 10  # warmup=2, iters=10, batches=1
    with pytest.raises(ValueError, match="mean|median|min"):
        timing.time_fn(lambda: None, stat="max")
    timing.sync(None)  # nothing to wait on
    timing.sync({"a": (torch.zeros(1), [torch.ones(2)])})  # CPU tensors only


def test_utils_exports_the_timer():
    import gspn_tpu_torch.utils as utils

    assert utils.sync is timing.sync and utils.time_fn is timing.time_fn
    assert set(utils.__all__) == {"sync", "time_fn"}


# debug


def test_checked_catches_nan_as_jax():
    err, out = debug.checked(torch.log)(torch.tensor([-1.0]))
    with pytest.raises(FloatingPointError, match="NaN or inf"):
        err.throw()
    assert torch.isnan(out).all() and err.get()
    jerr, _ = jchecked(jnp.log)(jnp.asarray([-1.0]))
    with pytest.raises(Exception):
        jerr.throw()
    ok, _ = debug.checked(lambda x: {"y": (torch.exp(x), torch.arange(3))})(torch.zeros(2))
    ok.throw()
    assert ok.get() is None

    @dataclasses.dataclass
    class Out:
        scores: torch.Tensor

    bad, _ = debug.checked(lambda: Out(torch.tensor([1.0, float("inf")])))()
    with pytest.raises(FloatingPointError, match="scores"):
        bad.throw()


class _ReportsCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


def test_plain_kernels_turns_auto_into_plain_and_restores():
    x = torch.zeros(2).as_subclass(_ReportsCuda)
    assert x.is_cuda and ops.resolve_impl("auto", x) == "cuda"
    with debug.plain_kernels():
        assert ops.resolve_impl("auto", x) == "plain"
        assert ops.resolve_impl("cuda", x) == "cuda"  # an explicit kernel stays one
        assert ops.resolve_impl("plain", x) == "plain"
    assert ops.resolve_impl("auto", x) == "cuda" and not common.AUTO_PLAIN
    with pytest.raises(RuntimeError), debug.plain_kernels():
        raise RuntimeError("inside")
    assert ops.resolve_impl("auto", x) == "cuda" and not common.AUTO_PLAIN


def _small_cases() -> dict:
    """One launch of each kernel that :func:`debug.extra_cases` does not
    give, at small shapes, in ``time_kernels.cases``' layout."""
    gen = torch.Generator().manual_seed(0)
    xyz = torch.rand((2, 2048, 3), generator=gen) * 2
    valid = torch.rand((2, 2048), generator=gen) > 0.1
    q = xyz[:, ::32].contiguous()
    half = torch.rand((2, 16, 3), generator=gen) * 0.4 + 0.1
    boxes = torch.cat([q[:, :16] - half, q[:, :16] + half], dim=-1)
    sxyz, svalid, _ = ops.spatial_sorted_view(xyz, valid)
    samp = q[:, :8, None] + (torch.rand((2, 8, 16, 3), generator=gen) - 0.5) * 0.2
    logits = torch.randn((2, 8, 16), generator=gen)
    tgt, src = xyz[:, :1024], xyz[:, :256]
    dist, idx = ops.three_nn(tgt, src, impl="plain")
    ball = ((0.4,), (16,), xyz, q, valid)
    group = (boxes, 32, xyz, valid)
    return {name: [(f"small {name}", args, ())] for name, args in (
        ("fps", (16, xyz[:, :100], valid[:, :100])),
        ("ball_group", ball), ("ball_group_strided", ball),
        ("ball_query", ball), ("ball_query_strided", ball),
        ("box_group", group), ("box_group_strided", group),
        ("three_nn", (tgt, src, None)),
        ("interp_mm", (torch.randn((2, 256, 64), generator=gen), idx, dist, None)),
        ("mask_project", (xyz, samp, logits)),
        ("mask_project_boxed", (sxyz, samp, logits, boxes[:, :8], None, svalid)),
        ("nms", (boxes, torch.rand((2, 16), generator=gen), 0.25)),
        ("nn_argmin", (tgt[:, :200], src, None, None)),
        ("index_add", (torch.randn((2, 256, 64), generator=gen),
                       torch.randint(0, 100, (2, 256), generator=gen, dtype=torch.int32), 100)),
    )}


def test_sanitize_cases_reach_every_kernel_launcher():
    """On the CPU each case's plain version runs, and its launch reaches the
    launcher's own CUDA check with the arguments it takes (a wrong
    argument would be a TypeError): every kernel of ``ops.KERNELS``, each
    case through its entry point, the forced plans of each kernel's first
    case and of the extra cases (the cluster FPS at 2-16 CTAs on rows of
    14,273 points, every three_nn plan with and without validity, the
    two-way argmin at each count of CTAs a row over several tiles)."""
    cases = debug.sanitize_cases(ops, torch.device("cpu"), _small_cases())
    assert {k for k, *_ in cases} == set(ops.KERNELS)
    paths = [f"{k} [{p}]" for k, p, *_ in cases]
    assert len(paths) == len(set(paths))
    for cs in (2, 4, 8, 16):
        assert any(p.startswith("fps_cluster") and p.endswith(f"plan {cs}]") for p in paths)
    nn = [p for p in paths if p.startswith("three_nn")]
    for plan in ("x".join(map(str, p)) for p in itertools.product(
            (1, 2, 4), (1, 2, 4, 8, 16, 32), (1, 32))):
        for tag in ("small three_nn", "sources masked"):
            assert any(tag in p and p.endswith(f"plan {plan}]") for p in nn), (plan, tag)
    for ctas in (1, 2, 4, 8, 12, 16):
        assert any("<-> 500" in p and p.endswith(f"plan {ctas}]") for p in paths), ctas
    # the kernel takes at most a CTA a tile of 256 targets
    assert {p.rsplit(" ", 1)[1] for p in paths if "small nn_argmin" in p and "plan" in p} == {"1]"}
    assert any(p.startswith("interp_mm") and p.endswith("x32]") for p in paths)  # staged
    assert any(p.startswith("ball_group_strided") and p.endswith("plan direct]") for p in paths)
    for kernel, path, launch, plain in cases:
        assert all(torch.is_tensor(t) for t in _flat(plain())), path
        with pytest.raises(ValueError, match="(?i)cuda"):
            launch()


def _flat(out):
    return [out] if torch.is_tensor(out) else [t for o in out for t in _flat(o)]


def test_sanitizer_command_and_verdict():
    cmd, env = debug.sanitizer_command("memcheck", ["python", "-m", "x"])
    assert cmd[1:] == ["--tool", "memcheck", "--error-exitcode", "1", *debug.SANITIZER_FILTER,
                       "python", "-m", "x"]
    assert env["PYTORCH_NO_CUDA_MEMORY_CACHING"] == "1"
    _, env = debug.sanitizer_command("racecheck", [])
    assert env.get("PYTORCH_NO_CUDA_MEMORY_CACHING") == os.environ.get(
        "PYTORCH_NO_CUDA_MEMORY_CACHING")
    done = f"{debug.SANITIZE_DONE}: 300 launches of 15 kernels\n"
    assert debug.sanitizer_clean(0, done + "========= ERROR SUMMARY: 0 errors\n")
    assert debug.sanitizer_clean(0, done + "========= RACECHECK SUMMARY: 0 hazards displayed "
                                 "(0 errors, 0 warnings)\n")
    assert not debug.sanitizer_clean(1, done + "========= ERROR SUMMARY: 2 errors\n")
    assert not debug.sanitizer_clean(0, done + "========= ERROR SUMMARY: 2 errors\n")
    assert not debug.sanitizer_clean(0, "========= ERROR SUMMARY: 0 errors\n")  # cut short
    assert not debug.sanitizer_clean(0, done)  # no summary: not sanitized


@pytest.mark.parametrize("rc, output, want", [
    (0, "1024.0\n========= ERROR SUMMARY: 0 errors\n", (True, "")),
    (1, "========= COMPUTE-SANITIZER\n========= Error: Device not supported. Please refer "
        "to the documentation\n", (False, "Error: Device not supported. Please refer to the "
                                          "documentation")),
    (1, "Traceback (most recent call last):\nImportError: no torch\n", AssertionError),
    (0, "1024.0\n", AssertionError),  # no summary: the tool did not run
])
def test_sanitizer_usable_leaves_out_only_an_unsupported_device(monkeypatch, rc, output, want):
    """The probe leaves (S-sanitize) out only where compute-sanitizer says
    "Device not supported"; any other failure of the probe raises."""
    monkeypatch.setattr(debug, "sanitizer_path", lambda: "compute-sanitizer")
    monkeypatch.setattr(debug.subprocess, "run", lambda *a, **k: subprocess.CompletedProcess(
        a[0], rc, stdout=output, stderr=""))
    if want is AssertionError:
        with pytest.raises(AssertionError, match="probe failed"):
            debug.sanitizer_usable()
    else:
        assert debug.sanitizer_usable() == want


# the faults each slice checks first


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_and_chip_smoke_import_nothing_of_jax():
    """Every import statement of the port's modules and ``chip_smoke.py``,
    those inside functions too, names neither JAX nor the JAX package."""
    files = sorted((REPO / "gspn_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 60
    bad = {str(f.relative_to(REPO)): sorted(roots) for f in files
           if (roots := _imported_roots(f) & {"jax", "jaxlib", "flax", "optax", "orbax",
                                              "gspn_tpu"})}
    assert not bad, bad
    res = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; print(sorted({m.split("
                          "'.')[0] for m in sys.modules} & {'jax', 'flax', 'gspn_tpu'}))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "[]", res.stderr


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("module", [
    "gspn_tpu_torch.train.train_gspn", "gspn_tpu_torch.train.train_rpointnet",
    "gspn_tpu_torch.eval.run_eval", "gspn_tpu_torch.eval.demo_predict",
    "gspn_tpu_torch.serve.export_serving", "gspn_tpu_torch.serve.serve_gspnx",
])
def test_entry_points_default_to_the_card(module, monkeypatch):
    """An entry point that runs on the card takes ``--device`` with the
    default ``cuda``."""
    def capture(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as caught:
        importlib.import_module(module).main([])
    device = [a for a in caught.value.args[0]._actions if "--device" in a.option_strings]
    assert len(device) == 1 and device[0].default == "cuda"
