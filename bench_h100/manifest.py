"""``BENCHMARK.json`` and the files it names: each configuration, traffic
mix and per-layer metric is a file of its own under this directory,
found by its name (``configs/<name>.json``, ``traffic/<name>.json``,
``metrics/<name>.py``), and each cell's correctness limits
(``limits/<cell>.json``). A later change adds a configuration, a cell or a
metric by adding files and entries, and edits no file that is there."""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent


def load(root: pathlib.Path) -> dict:
    """The benchmark's manifest at ``root`` (a checkout's root)."""
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(name: str, base: pathlib.Path = HERE) -> dict:
    return json.loads((base / "configs" / f"{name}.json").read_text())


def traffic(name: str, base: pathlib.Path = HERE) -> dict:
    return json.loads((base / "traffic" / f"{name}.json").read_text())


def limits(cell: str, base: pathlib.Path = HERE) -> dict:
    """The correctness limits of a cell: ``{number: limit}``."""
    return json.loads((base / "limits" / f"{cell}.json").read_text())


def metric_reader(name: str, base: pathlib.Path = HERE):
    """``read(ctx) -> float | None`` of ``metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_h100_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


def end_to_end(manifest: dict, cell: str) -> list[dict]:
    """The end-to-end metrics a cell reports."""
    return [m for m in manifest["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def per_layer(manifest: dict, cell: str) -> list[dict]:
    """The per-layer metrics a cell's traced run reports: those listing the
    cell, or, without a list, those that move an end-to-end metric the
    cell reports."""
    reported = {m["name"] for m in end_to_end(manifest, cell)}
    return [m for m in manifest["per_layer"] if _applies(m, cell, reported)]
