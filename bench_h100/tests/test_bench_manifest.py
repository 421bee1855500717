"""The manifest keeps to the benchmark's contract, and every configuration,
traffic mix and per-layer metric is a file found by its name."""

from __future__ import annotations

import json
import re
import sys

import pytest

from tiny import HERE, ROOT

sys.path.insert(0, str(ROOT))

from bench_h100 import manifest  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = manifest.load(ROOT)


def test_manifest_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert MAN["paths"] == ["bench_h100"] and MAN["command"][1] == "bench_h100/run.py"
    assert 1 <= MAN["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MAN[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and all(0 < m["bound"] <= 0.25 for m in e2e.values())
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_file_is_found_by_name(cell):
    w = manifest.workload(MAN, cell)
    cfg = manifest.config(w["config"])
    assert cfg["name"] == w["config"] and manifest.limits(cell)
    assert manifest.traffic(w["traffic"])["pool"] >= 1
    reported = manifest.end_to_end(MAN, cell)
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    layer = manifest.per_layer(MAN, cell)
    assert layer
    for m in layer:
        assert callable(manifest.metric_reader(m["name"]))
    entry = next(c for c in MAN["configs"] if c["name"] == w["config"])
    assert (ROOT / entry["file"]).is_file()


def test_a_new_config_traffic_and_metric_are_files_of_their_own(tmp_path):
    """A later change adds files and entries and edits none: a dummy
    configuration, traffic mix and metric in a copy of the tree are
    found by name, and the files that were there are unchanged."""
    import shutil

    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(HERE / sub, tmp_path / sub)
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    cfg = dict(manifest.config("scannet-pipeline"), name="dummy-pipeline")
    (tmp_path / "configs" / "dummy-pipeline.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "dummy-mix.json").write_text(json.dumps(
        dict(manifest.traffic("serve-b8n8192"), batch=2)))
    (tmp_path / "metrics" / "dummy_ms.serve.py").write_text(
        "def read(ctx):\n    return 1.5 if ctx['kind'] == 'serve' else None\n")
    man = json.loads(json.dumps(MAN))
    man["workloads"].append({"name": "dummy.cell", "config": "dummy-pipeline",
                             "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "dummy_ms.serve", "unit": "ms", "better": "lower",
                             "source": "host_clock", "layer": "device",
                             "moves": "serve_points_per_s", "workloads": ["dummy.cell"]})
    assert manifest.config("dummy-pipeline", tmp_path)["name"] == "dummy-pipeline"
    assert manifest.traffic("dummy-mix", tmp_path)["batch"] == 2
    names = [m["name"] for m in manifest.per_layer(man, "dummy.cell")]
    assert names == ["dummy_ms.serve"]
    assert manifest.metric_reader("dummy_ms.serve", tmp_path)({"kind": "serve"}) == 1.5
    assert all(p.read_bytes() == b for p, b in before.items())


def test_config_files_are_the_ports_presets():
    """The configuration files hold the port's presets as shipped (the
    serving one with its two thresholds moved), field for field."""
    import dataclasses

    from bench_h100 import program
    from gspn_tpu_torch.models.gspn import GSPNConfig
    from gspn_tpu_torch.models.presets import scannet_pipeline

    pipe = program.pipeline_config(manifest.config("scannet-pipeline"))
    assert pipe == dataclasses.replace(scannet_pipeline(), score_thresh=0.0, mask_thresh=0.49)
    assert program.gspn_config(manifest.config("gspn-stage1")) == GSPNConfig()
    s2 = scannet_pipeline(fps_segments=1)
    cfg = manifest.config("rpointnet-stage2")
    assert program.gspn_config(cfg) == s2.gspn
    assert program.rpointnet_config(cfg) == s2.rpointnet
