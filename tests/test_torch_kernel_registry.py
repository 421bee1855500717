"""The port's kernel registry against its CUDA sources, on any machine.

``gspn_tpu_torch.ops._cuda.KERNELS`` names each kernel's C entry point and
argument types; ``chip_smoke.DEVICE_SYMBOLS`` names the ``__global__``
functions whose profiler events give each kernel's device time. Nothing
compiles here, so a renamed kernel or a changed signature shows up only on
the card unless these tests read the sources.
"""

import re

import pytest
import torch

import chip_smoke
from gspn_tpu_torch import ops
from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.utils import time_kernels

NAMES = sorted(_cuda.KERNELS)
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def _sources():
    return {p.name: p.read_text() for p in _cuda.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}


def _entry_params(text: str, symbol: str) -> list[str]:
    """The parameters of ``extern "C" int symbol(...)`` in ``text``."""
    m = re.search(r'extern "C" int ' + re.escape(symbol) + r"\(([^)]*)\)", text)
    assert m, f"no extern \"C\" int {symbol}(...)"
    return [p.strip() for p in m.group(1).split(",")]


def test_build_files_exist():
    for name in _cuda.SOURCES + _cuda.HEADERS:
        assert (_cuda.CSRC / name).is_file(), name
    assert set(_sources()) == set(_cuda.SOURCES + _cuda.HEADERS)


@pytest.mark.parametrize("name", NAMES)
def test_kernel_has_device_symbols(name):
    symbols = chip_smoke.DEVICE_SYMBOLS[name]
    assert symbols and all(isinstance(s, str) and s for s in symbols)


@pytest.mark.parametrize("name", NAMES)
def test_device_symbols_name_global_functions(name):
    """Each symbol's function (template arguments aside) is a ``__global__``
    function of a source the build compiles."""
    declared = {f for text in _sources().values() for f in _GLOBAL.findall(text)}
    for symbol in chip_smoke.DEVICE_SYMBOLS[name]:
        assert symbol.split("<")[0] in declared, (symbol, sorted(declared))


@pytest.mark.parametrize("name", NAMES)
def test_entry_point_takes_the_registered_arguments(name):
    """The C entry point lives in the kernel's source and takes one
    parameter for each registered argument type, then the stream."""
    k = _cuda.KERNELS[name]
    params = _entry_params((_cuda.CSRC / k.source.rsplit("/", 1)[1]).read_text(), k.symbol)
    assert params[-1] == "cudaStream_t stream"
    assert len(params) - 1 == len(k.argtypes), params
    ints = [p for p, t in zip(params, k.argtypes, strict=False) if t is _cuda._int]
    assert all(p.startswith("int ") for p in ints), params


@pytest.mark.parametrize("name", sorted(time_kernels.SYMBOLS))
def test_time_kernels_finds_the_current_symbols(name):
    """``time_kernels.py`` times a kernel of this tree by the symbols
    ``chip_smoke.py`` reads (besides an older tree's), through an entry
    point that ``gspn_tpu_torch.ops`` exports."""
    assert set(chip_smoke.DEVICE_SYMBOLS[name]) <= set(time_kernels.SYMBOLS[name])
    assert callable(getattr(ops, time_kernels.ENTRY_POINTS[name]))


def _ranking_inputs(a_launches, g_launches, h_launches):
    """Two kernels of slice (A) at two shapes each, two of slice (H) (one
    shared with (A)), two of a training step (G) (each launched once, the
    chamfer's argmins both ways in one launch), and one off the ranked
    slices."""
    requests = {"(A) B8xN8192": [("fps", "f1"), ("fps", "f2"), ("nms", "n1")],
                "(A) B1xN65536": [("fps", "f3"), ("fps", "f4"), ("nms", "n2")],
                "(G) B4xN4096": [("index_add", "i1"), ("nn_argmin", "m1")],
                "(H) B8xN8192": [("fps", "f1"), ("nms", "n1")],
                "(H) B1xN65536": [("fps_cluster", "c1"), ("nms", "n2")]}
    entries = [
        {"name": "fps", "device_ms_by_shape": {"f1": 1.0, "f2": 0.5, "f3": 2.0, "f4": None},
         "bound_ms_by_shape": {"f1": 0.25, "f2": 0.25, "f3": 0.5, "f4": 0.1}},
        {"name": "nms", "device_ms_by_shape": {"n1": 0.125, "n2": 0.25},
         "bound_ms_by_shape": {"n1": 0.0, "n2": 0.0}},
        {"name": "fps_cluster", "device_ms_by_shape": {"c1": 2.5},
         "bound_ms_by_shape": {"c1": 0.5}},
        {"name": "index_add", "device_ms_by_shape": {"i1": 0.75},
         "bound_ms_by_shape": {"i1": 0.5}},
        {"name": "nn_argmin", "device_ms_by_shape": {"m1": 0.5},
         "bound_ms_by_shape": {"m1": 0.125}},
        {"name": "three_nn", "slice": "C", "launches": chip_smoke.VARIANT_REQUESTS + 1,
         "device_ms": 0.125, "bound_ms": 0.0625},
    ]
    runs = {"A": a_launches, "G": g_launches, "H": h_launches}
    return entries, requests, runs


@pytest.mark.parametrize("short", ["", "A", "G", "H"],
                         ids=["as_slice_a", "a_launch_short", "g_launch_short", "h_launch_short"])
def test_ranking_charges_each_launch_at_its_own_shape(capsys, monkeypatch, short):
    """``chip_smoke``'s ranking sums (device - bound) over each request's
    (or training step's) launches at their own shapes, for every ranked
    slice's requests, names the launches it could not time, ranks the
    kernels no ranked request launches by slice, and refuses a launch plan
    that is not the slice's."""
    monkeypatch.setattr(chip_smoke, "SLICE_KERNELS",
                        {"A": {"fps", "nms"}, "G": {"index_add", "nn_argmin"},
                         "H": {"fps", "fps_cluster", "nms"}})
    per_a, per_h = chip_smoke.REQUESTS + 1, chip_smoke.VARIANT_REQUESTS + 1
    per_g = chip_smoke.TRAIN_STEPS + 1
    entries, requests, runs = _ranking_inputs(
        {"fps": 4 * per_a - (short == "A"), "nms": 2 * per_a},
        {"index_add": per_g - (short == "G"), "nn_argmin": per_g},
        {"fps": per_h, "fps_cluster": per_h - (short == "H"), "nms": 2 * per_h})
    if short:
        name = {"A": "fps", "G": "index_add", "H": "fps_cluster"}[short]
        with pytest.raises(AssertionError, match=f"{name}: slice \\({short}\\) launched it"):
            chip_smoke._print_ranking(entries, requests, runs)
        return
    chip_smoke._print_ranking(entries, requests, runs)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("ms above the bound per (A) B8xN8192 request, each of its 3")
    assert out[0].endswith("fps 1.0000, nms 0.1250; total 1.1250")
    assert "fps 1.5000, nms 0.2500; total 1.7500; not measured: fps [f4]" in out[1]
    assert out[2].startswith("ms above the bound per (G) B4xN4096 step, each of its 2")
    assert out[2].endswith("nn_argmin 0.3750, index_add 0.2500; total 0.6250")
    assert out[3].endswith("fps 0.7500, nms 0.1250; total 0.8750")
    assert out[4].endswith("fps_cluster 2.0000, nms 0.2500; total 2.2500")
    assert out[5].endswith("(C) three_nn 1 x = 0.0625")


def test_ranking_names_every_ranked_request():
    """``time_kernels.ranked_keys``: both request shapes of (A), (B), (E),
    (F) and (H), and the training batch of (G) and (I)."""
    both = [f"({s}) {shape}" for s in "ABEFH" for shape in ("B8xN8192", "B1xN65536")]
    assert time_kernels.ranked_keys() == (both[:8] + ["(G) B4xN4096"] + both[8:]
                                          + ["(I) B4xN4096"])


def test_strided_plan_constants_match_the_kernel():
    """The strided groups' wrapper sizes the kernel's ballot scratch and
    shared memory from the kernel's tile, step and CTA sizes: they must be
    the sources' (a smaller scratch than the kernel writes would corrupt
    memory)."""
    from gspn_tpu_torch.ops import ball_query as tquery

    text = (_cuda.CSRC / "group_first.cuh").read_text()

    def const(name):
        m = re.search(r"constexpr int " + name + r" = (\d+);", text)
        assert m, name
        return int(m.group(1))

    assert tquery.STRIDED_TILE == const("kTile")
    assert tquery.STRIDED_CTA_WARPS == const("kCtaWarps")
    assert tquery.STRIDED_DIRECT_WARPS == const("kDirectWarps")
    assert tquery.STRIDED_STEP == 32 * const("kGroups")
    assert tquery.STRIDED_SPLITS[-1] == const("kMaxSplit")
    assert "return (n + kStep - 1) / kStep * kGroups;" in (
        _cuda.CSRC / "group_strided.cuh").read_text()


def test_index_add_plan_constants_match_the_kernel():
    """``index_add_plan`` sizes the kernel's tiles from its limits: they
    must be the source's (the kernel refuses a plan beyond them)."""
    from gspn_tpu_torch.ops import grouping as tgroup

    text = (_cuda.CSRC / "index_add.cu").read_text()

    def const(name):
        m = re.search(r"constexpr int " + name + r" = (\d+);", text)
        assert m, name
        return int(m.group(1))

    assert tgroup.INDEX_ADD_MAX_BINS == const("kMaxBins")
    assert tgroup.INDEX_ADD_ACC_FLOATS == const("kAccFloats")


def _constant(source: str, name: str) -> int:
    m = re.search(r"constexpr int " + name + r" = (\d+);",
                  (_cuda.CSRC / source).read_text())
    assert m, name
    return int(m.group(1))


def test_nn_argmin_plan_constants_match_the_kernel():
    """``nn_argmin_plan`` sizes the scratch and the CTAs a row from the
    kernel's targets a CTA and its most CTAs a row: they must be the
    source's (a tile count below the kernel's would leave the scratch
    unallocated; the kernel refuses more CTAs a row)."""
    from gspn_tpu_torch.ops import chamfer as tchamfer

    assert "constexpr int kTargets = kLanes * kPer;" in (_cuda.CSRC / "chamfer.cu").read_text()
    assert tchamfer.NN_ARGMIN_TARGETS == (_constant("chamfer.cu", "kLanes")
                                          * _constant("chamfer.cu", "kPer"))
    assert tchamfer.NN_ARGMIN_MAX_SPLIT == _constant("chamfer.cu", "kMaxSplit")


def test_interp_mm_plan_constants_match_the_kernel():
    """``interp_mm_plan`` keeps the rows a task and a staged chunk within
    the kernel's limits and slices in the kernel's unit."""
    from gspn_tpu_torch.ops import interpolate as tinterp

    assert tinterp.INTERP_MM_MAX_ROWS == _constant("interp_mm.cu", "kMaxRows")
    assert tinterp.INTERP_MM_SLICE == _constant("interp_mm.cu", "kSliceUnit")
    assert tinterp.INTERP_MM_MAX_CHUNK == _constant("interp_mm.cu", "kMaxChunk")


def test_profile_slice_names_global_functions():
    """``profile_slice``'s hand-written kernels are ``__global__`` functions
    of the sources (a renamed kernel would drop out of its sums)."""
    from gspn_tpu_torch.utils.profile_slice import HAND_WRITTEN

    declared = {f for text in _sources().values() for f in _GLOBAL.findall(text)}
    assert {h.split("<")[0] for h in HAND_WRITTEN} <= declared


def _bn_layers(model, prefix: str = "") -> int:
    from gspn_tpu_torch.nn.layers import MaskedBatchNorm

    return sum(isinstance(m, MaskedBatchNorm) and name.startswith(prefix)
               for name, m in model.named_modules())


def test_chip_smoke_counts_every_trained_batch_norm():
    """``chip_smoke``'s BatchNorm launches a step are one of each kernel for
    every ``MaskedBatchNorm`` of the slices' models: stage 1 at
    ``train_config()`` and the object preset, stage 2's R-PointNet, and
    remat's recompute of the SA and FP modules' forward; the slices' other
    kernels are the point kernels' counts."""
    from gspn_tpu_torch.models.gspn import shapenet_config
    from gspn_tpu_torch.utils import bench_slice

    cpu = torch.device("cpu")
    gspn = bench_slice.seeded_gspn(bench_slice.train_config(), cpu)
    obj = bench_slice.seeded_gspn(shapenet_config(chip_smoke.OBJECT_N, num_gen_points=512), cpu)
    rpn = bench_slice.seeded_rpointnet(bench_slice.stage2_configs()[1], cpu)
    assert chip_smoke.G_BN == _bn_layers(gspn)
    assert chip_smoke.OBJECT_BN == _bn_layers(obj)
    assert chip_smoke.I_BN == _bn_layers(rpn)
    assert chip_smoke.I_REMAT_BN == sum(_bn_layers(rpn, f"backbone.{level}")
                                        for level in ("sa", "fp"))
    bn = set(time_kernels.BN_SYMBOLS)
    for per_step, points, layers in ((chip_smoke.G_PER_STEP, chip_smoke.G_POINTS, 15),
                                     (chip_smoke.OBJECT_PER_STEP, chip_smoke.G_POINTS, 9),
                                     (chip_smoke.I_PER_STEP, chip_smoke.I_POINTS, 25)):
        assert {k: c for k, c in per_step.items() if k not in bn} == points
        assert {per_step[k] for k in bn} == {layers}
    q = chip_smoke.Q_PER_STEP
    assert (q["bn_stats"], q["bn_apply"], q["bn_grad_terms"], q["bn_grad_input"]) == (
        46, 46, 25, 25)
