"""Nothing the benchmark's command loads, nor anything the reference
loads, is JAX or the JAX package; the reference loads nothing of the
program. Top-level names are compared whole: the program's
``gspn_tpu_torch`` is not the JAX package's ``gspn_tpu``."""

from __future__ import annotations

import json
import subprocess
import sys

from tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gspn_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


PRELUDE = f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, " \
          f"{str(ROOT / 'bench_h100' / 'tests')!r})\n"
TOP = "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"


def test_the_command_loads_no_jax_through_a_whole_run():
    """``run.py`` and every module it loads, through a whole tiny run of a
    serving cell and a training cell on the CPU."""
    code = PRELUDE + (
        "import pathlib, tempfile, torch\n"
        "from bench_h100 import run, manifest\n"
        "from tiny import tiny_tree\n"
        "base, man = tiny_tree(pathlib.Path(tempfile.mkdtemp()) / 'b')\n"
        "for name in ('scannet-serve-b8n8192', 'rpointnet-train-b32'):\n"
        "    r = run.run_cell(man, manifest.workload(man, name), 11, 0.5, False,\n"
        "                     torch.device('cpu'), 0.0, base=base)\n"
        "    assert r['attempted'] > 0\n"
        "assert run.forbidden_modules() == []\n" + TOP)
    loaded = _loaded(code)
    assert "gspn_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = PRELUDE + (
        "from bench_h100.reference import model, ops, train\n"
        "from bench_h100 import workcount\n" + TOP)
    loaded = _loaded(code)
    assert not loaded & (FORBIDDEN | {"gspn_tpu_torch"})


def test_the_forbidden_check_compares_whole_top_level_names():
    code = PRELUDE + (
        "from bench_h100 import run\n"
        "import types\n"
        "sys.modules['gspn_tpu_torch_extra'] = types.ModuleType('gspn_tpu_torch_extra')\n"
        "a = run.forbidden_modules()\n"
        "sys.modules['gspn_tpu.models'] = types.ModuleType('gspn_tpu.models')\n"
        "print(json.dumps(a + ['|'] + run.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == ["|", "gspn_tpu"]
