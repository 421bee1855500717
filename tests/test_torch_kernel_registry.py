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
from gspn_tpu_torch.ops import _cuda

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
