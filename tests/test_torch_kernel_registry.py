"""The port's kernel registry against its CUDA sources, on any machine.

``gspn_tpu_torch.ops._cuda.KERNELS`` names each kernel's C entry point and
argument types; ``chip_smoke.DEVICE_SYMBOLS`` names the ``__global__``
functions whose profiler events give each kernel's device time. Nothing
compiles here, so a renamed kernel or a changed signature shows up only on
the card unless these tests read the sources.
"""

import re

import pytest

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


def _ranking_inputs(a_launches):
    """Two kernels of the main path at two shapes each, and one off it."""
    requests = {"B8xN8192": [("fps", "f1"), ("fps", "f2"), ("nms", "n1")],
                "B1xN65536": [("fps", "f3"), ("fps", "f4"), ("nms", "n2")]}
    entries = [
        {"name": "fps", "device_ms_by_shape": {"f1": 1.0, "f2": 0.5, "f3": 2.0, "f4": None},
         "bound_ms_by_shape": {"f1": 0.25, "f2": 0.25, "f3": 0.5, "f4": 0.1}},
        {"name": "nms", "device_ms_by_shape": {"n1": 0.125, "n2": 0.25},
         "bound_ms_by_shape": {"n1": 0.0, "n2": 0.0}},
        {"name": "fps_cluster", "slice": "H", "launches": 4, "device_ms": 2.5,
         "bound_ms": 0.5},
    ]
    runs = {"A": {name: 0 for name in chip_smoke.SLICE_KERNELS["A"]}}
    runs["A"].update(a_launches)
    return entries, requests, runs


@pytest.mark.parametrize("short", [False, True], ids=["as_slice_a", "a_launch_short"])
def test_ranking_charges_each_launch_at_its_own_shape(capsys, monkeypatch, short):
    """``chip_smoke``'s ranking sums (device - bound) over each request's
    launches at their own shapes, names the launches it could not time, and
    refuses a launch plan that is not slice (A)'s."""
    monkeypatch.setattr(chip_smoke, "SLICE_KERNELS", {"A": {"fps", "nms"}})
    per_pair = chip_smoke.REQUESTS + 1
    entries, requests, runs = _ranking_inputs(
        {"fps": 4 * per_pair - short, "nms": 2 * per_pair})
    if short:
        with pytest.raises(AssertionError, match="fps: slice \\(A\\) launched it"):
            chip_smoke._print_ranking(entries, requests, runs)
        return
    chip_smoke._print_ranking(entries, requests, runs)
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("fps 1.0000, nms 0.1250; total 1.1250")
    assert "fps 1.5000, nms 0.2500; total 1.7500; not measured: fps [f4]" in out[1]
    assert out[2].endswith("(H) fps_cluster 0.5 x = 1.0000")


def test_profile_slice_names_global_functions():
    """``profile_slice``'s hand-written kernels are ``__global__`` functions
    of the sources (a renamed kernel would drop out of its sums)."""
    from gspn_tpu_torch.utils.profile_slice import HAND_WRITTEN

    declared = {f for text in _sources().values() for f in _GLOBAL.findall(text)}
    assert {h.split("<")[0] for h in HAND_WRITTEN} <= declared
