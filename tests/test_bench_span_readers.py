"""The benchmark's readers of the program's spans and counters
(``bench_h100/metrics/<name>.py`` over ``bench_h100/program_spans.py``):
each gives its number from ``span_stats()`` (and ``launch_counts()``),
and None where nothing was recorded or the program has no counters."""

from __future__ import annotations

import pathlib
import sys

import pytest

from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench_h100 import manifest  # noqa: E402


def _entry(count, total_s):
    return {"count": count, "total_s": total_s, "mean_ms": 1e3 * total_s / count}


# 4 requests of predict (40 ms in all), set-up once; 10 training steps,
# 8 of them measured on the stream
STATS = {
    "serve.predict": _entry(4, 0.040), "serve.inputs": _entry(8, 0.008),
    "serve.lock_wait": _entry(4, 0.012), "serve.launch": _entry(4, 0.004),
    "serve.device_wait": _entry(4, 0.010), "serve.fetch": _entry(4, 0.004),
    "serve.assemble": _entry(4, 0.002), "serve.export": _entry(1, 12.5),
    "serve.open": _entry(1, 6.25), "train.step": _entry(10, 0.30),
    "train.forward@stream": _entry(8, 0.16), "train.backward@stream": _entry(8, 0.24),
    "train.optimizer@stream": _entry(8, 0.04), "train.proposals@stream": _entry(8, 0.08),
}
EXPECTED = {
    "predict_inputs_ms.serve": 2.0, "predict_lock_wait_ms.serve": 3.0,
    "predict_launch_ms.serve": 1.0, "predict_device_wait_ms.serve": 2.5,
    "predict_fetch_ms.serve": 1.0, "predict_assemble_ms.serve": 0.5,
    "export_s.serve": 12.5, "session_open_s.serve": 6.25,
    "step_host_ms.train": 30.0, "forward_stream_ms.train": 20.0,
    "backward_stream_ms.train": 30.0, "optimizer_stream_ms.train": 5.0,
    "proposals_stream_ms.train": 10.0, "gspn_launches.train": 2.6,
}
MAN = manifest.load(ROOT)


def test_the_manifest_names_each_reader_once():
    spans = [m for m in MAN["per_layer"] if m["name"] in EXPECTED]
    assert sorted(m["name"] for m in spans) == sorted(EXPECTED)
    for m in spans:
        assert m["source"] == "program_span" and m["workloads"]
        kind = m["name"].rsplit(".", 1)[1]
        assert all(kind in w for w in m["workloads"])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_fake_counters_and_on_nothing(name, monkeypatch):
    read = manifest.metric_reader(name)
    kind = name.rsplit(".", 1)[1]
    counts = {k: 0 for k in _cuda.KERNELS} | {"fps": 10, "nn_argmin": 10, "index_add": 6}
    monkeypatch.setattr(_cuda, "launch_counts", lambda: counts)
    monkeypatch.setattr(profiling, "span_stats", lambda: STATS)
    assert read({"kind": kind}) == pytest.approx(EXPECTED[name])
    assert read({"kind": "train" if kind == "serve" else "serve"}) is None
    monkeypatch.setattr(profiling, "span_stats", lambda: {})
    assert read({"kind": kind}) is None
    # a program without the counters: nothing
    monkeypatch.delattr(profiling, "span_stats")
    assert read({"kind": kind}) is None
