"""The port's spans and counters (``utils/profiling.py`` ``span``): counts
and totals from several threads, the timeline only while a recorder is
on and mapped onto the profiler's clock by its anchor, the idle gaps
labelled by the innermost span, stream times read only once complete,
and the spans of a served request, a training step and set-up."""

from __future__ import annotations

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gspn_tpu_torch.data import synthetic
from gspn_tpu_torch.models import pipeline as tpl
from gspn_tpu_torch.models.gspn import GSPN
from gspn_tpu_torch.models.rpointnet import RPointNetConfig, SALayerSpec
from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.serve import InferenceSession, export_inference, save_artifact
from gspn_tpu_torch.train import steps
from gspn_tpu_torch.train.train_gspn import TINY_GSPN
from gspn_tpu_torch.utils import profiling

SERVE_PARTS = ("inputs", "lock_wait", "launch", "device_wait", "fetch", "assemble")


@pytest.fixture(autouse=True)
def fresh_counters():
    profiling.reset_span_stats()
    yield
    profiling.reset_span_stats()


def _stats():
    return {k: v for k, v in profiling.span_stats().items() if v["count"]}


def test_counts_totals_nesting_and_ids():
    with profiling.record_spans() as rec:
        with profiling.span("outer"):
            time.sleep(0.002)
            with profiling.span("inner"):
                time.sleep(0.003)
        with profiling.span("outer"):
            pass
    st = _stats()
    assert st["outer"]["count"] == 2 and st["inner"]["count"] == 1
    assert st["inner"]["total_s"] >= 0.003 and st["outer"]["total_s"] >= 0.005
    assert st["outer"]["mean_ms"] == pytest.approx(st["outer"]["total_s"] * 1e3 / 2)
    inner, first, second = (dict(zip(profiling.RECORD_FIELDS, r)) for r in rec.records)
    assert (inner["name"], inner["parent"], inner["depth"]) == ("inner", "outer", 1)
    assert (first["parent"], first["depth"]) == (None, 0)
    # the spans of one outermost span share its id; the next one takes another
    assert inner["id"] == first["id"] != second["id"]
    assert first["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= first["end_ns"]
    assert inner["thread"] == threading.get_ident()


def test_four_threads_at_once_lose_no_count_and_leave_no_table():
    tables = len(profiling._TABLES)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        together = threading.Barrier(4)  # all four alive at once: four thread idents
        with profiling.record_spans() as rec:
            def work():
                together.wait(timeout=60)
                for _ in range(500):
                    with profiling.span("t.outer"), profiling.span("t.inner"):
                        pass

            threads = [threading.Thread(target=work) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    st = _stats()
    assert st["t.outer"]["count"] == st["t.inner"]["count"] == 2000
    # an ended thread's table is folded into the retired one
    assert len(profiling._TABLES) == tables
    assert len({r[3] for r in rec.records}) == 4 and len(rec.records) == 4000
    by_id = {}
    for r in rec.records:
        by_id.setdefault(r[5], set()).add((r[0], r[3]))
    assert all(len(v) == 2 and len({t for _, t in v}) == 1 for v in by_id.values())


def test_no_record_function_or_record_while_nothing_is_on(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a):
        calls.append(name)
        return real(name, *a)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    rec = profiling.SpanRecorder()
    with profiling.span("quiet"):
        pass
    assert calls == [] and rec.records == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("loud"):
            pass
    assert calls == ["loud"]
    rec.start()
    with profiling.span("kept"):
        pass
    rec.stop()
    with profiling.span("after"):
        pass
    assert [r[0] for r in rec.records] == ["kept"]
    assert _stats()["quiet"]["count"] == _stats()["after"]["count"] == 1


def test_anchor_maps_spans_onto_the_profilers_clock(tmp_path):
    errors = []
    for attempt in range(3):  # the best of three: a loaded host may preempt a clock read
        out = tmp_path / f"prof{attempt}"
        with profiling.trace(out) as prof:
            with profiling.span("mapped.outer"):
                time.sleep(0.004)
                with profiling.span("mapped.inner"):
                    time.sleep(0.003)
        written = json.loads((out / "spans.json").read_text())
        assert written["anchor"] == profiling.ANCHOR and len(written["records"]) == 2
        assert json.loads((out / "trace.json").read_text())
        events = prof.events()
        rec = profiling.SpanRecorder()
        rec.anchor_ns, rec.records = written["anchor_ns"], [tuple(r) for r in written["records"]]
        mapped = rec.on_profiler_clock(events)
        assert len(mapped) == 2
        err = 0.0
        for name, start, end, _ in mapped:
            ev = next(e for e in events if e.name == name)
            err = max(err, abs(start - ev.time_range.start), abs(end - ev.time_range.end))
        errors.append(err)
        if err < 1000:
            break
    assert min(errors) < 1000  # us


def test_idle_gaps_are_labelled_by_the_innermost_span():
    kernels = [(0, 10), (8, 20), (25, 40), (100, 110), (300, 305), (306, 320), (400, 410)]
    spans = [("step", 0, 500, 0), ("step.forward", 0, 150, 1), ("other", 90, 400, 0)]
    gaps = profiling.idle_gaps(kernels, spans)
    # 20-25 is under 10 us; 40-100 (mid 70) in forward; 110-300 (mid 205) in
    # step and other, both depth 0: the later start; 305-306 short; 320-400
    # (mid 360) likewise
    assert gaps == [["other (2 gaps)", pytest.approx(270e-6)],
                    ["step.forward (1 gaps)", pytest.approx(60e-6)]]
    assert profiling.idle_gaps([(0, 1), (50, 60)], []) == [["no span (1 gaps)",
                                                           pytest.approx(49e-6)]]


def test_step_trace_window_writes_spans_and_gap_labels(tmp_path, capsys):
    win = profiling.StepTraceWindow(tmp_path / "trace", start=1, count=2, device="cpu")
    for i in range(4):
        win.tick(i)
        with profiling.span("train.step"):
            torch.ones(64).sum()
    win.close()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["profiled_steps"] == 2 and line["idle_gaps"] == []  # no device kernels
    records = json.loads((tmp_path / "trace" / "spans.json").read_text())["records"]
    assert [r[0] for r in records] == ["train.step", "train.step"]


class _FakeEvent:
    """A CUDA event stand-in: ``record`` stamps a fake clock; ``query`` is
    true once the fake device has passed the stamp."""

    device_ms = 0.0

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self, stream=None):
        self.at = _FakeEvent.device_ms

    def query(self):
        return self.at is not None and self.at <= _FakeEvent.done_ms

    def elapsed_time(self, other):
        return other.at - self.at


def test_stream_phases_read_only_completed_sets(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(profiling, "STREAM_EVENT_SETS", 2)
    made = []
    clock = profiling.StreamPhases(("p.a", "p.b"))
    _FakeEvent.done_ms = -1.0
    for step in range(3):
        _FakeEvent.device_ms = 10.0 * step
        clock.start("cuda")
        made.append(clock._sets)
        _FakeEvent.device_ms += 2.0
        clock.mark(1)
        _FakeEvent.device_ms += 5.0
        clock.mark(2)
    # the device finished nothing: two sets pending, the third start found
    # none free and recorded nothing
    assert "p.a@stream" not in _stats() and len(clock._pending) == 2
    assert all(s is made[0] for s in made)  # one pool, made once
    _FakeEvent.done_ms = 1e9
    clock.poll()
    st = _stats()
    assert st["p.a@stream"]["count"] == 2 and st["p.a@stream"]["mean_ms"] == pytest.approx(2.0)
    assert st["p.b@stream"]["mean_ms"] == pytest.approx(5.0)
    clock.start("cpu")  # off the card: nothing
    assert _stats()["p.a@stream"]["count"] == 2


def test_launch_counter_is_safe_under_threads(monkeypatch):
    class Lib:
        @staticmethod
        def gspn_fps(*args):
            return 0

    monkeypatch.setattr(_cuda, "library", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 0, raising=False)
    kernel = _cuda.KERNELS["fps"]
    before = _cuda.launch_counts()["fps"]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kernel.launch(torch.device("cuda", 0))
                                                    for _ in range(2000)]) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert _cuda.launch_counts()["fps"] == before + 8000
    kernel.launches = before


TINY = tpl.PipelineConfig(
    gspn=TINY_GSPN,
    rpointnet=RPointNetConfig(
        sa_layers=(SALayerSpec(32, 0.4, 8, (8, 16)), SALayerSpec(8, 0.8, 8, (16, 16))),
        fp_mlps=((16,), (16, 16)), roi_samples=8, roi_mlp=(16,), cls_fc=(16,), box_fc=(16,),
        mask_mlp=(16,), num_classes=3),
    num_seeds=12, score_thresh=0.0)
N, B = 192, 2


def test_predict_records_each_part_once_a_chunk_and_they_tile_it(tmp_path):
    state = tpl.init_pipeline_variables(TINY, torch.Generator().manual_seed(0), N)
    model = tpl.PipelineModel(TINY)
    model.load_state_dict(state)
    program = export_inference(TINY, model.eval(), N, batch_size=B, device="cpu")
    session = InferenceSession(save_artifact(tmp_path / "t.gspnt", program, TINY), state,
                               device="cpu")
    st = _stats()
    assert st["serve.export"]["count"] == st["serve.open"]["count"] == 1
    sb = synthetic.scene_batch(np.random.default_rng(0), 3, n_points=N, max_instances=3,
                               extent=2.0)
    for b in (2, 3):  # one chunk, then two
        untiled = []
        for _ in range(3):  # the best of three: a loaded host may stall between spans
            profiling.reset_span_stats()
            session.predict(sb["xyz"][:b], sb["valid"][:b], seed=5)
            st = _stats()
            chunks = -(-b // B)
            assert st["serve.predict"]["count"] == 1
            assert st["serve.inputs"]["count"] == 1 + chunks  # the checks, then each chunk's
            for part in SERVE_PARTS[1:5]:
                assert st[f"serve.{part}"]["count"] == chunks, part
            assert st["serve.assemble"]["count"] == 1
            parts = sum(st[f"serve.{p}"]["total_s"] for p in SERVE_PARTS)
            assert parts <= st["serve.predict"]["total_s"]
            untiled.append(1 - parts / st["serve.predict"]["total_s"])
        assert min(untiled) < 0.05


def test_a_training_step_records_its_span_and_phases():
    torch.manual_seed(0)
    model = GSPN(TINY_GSPN, recognition=True).train()
    ts = steps.TrainState(model, steps.make_optimizer(model, 1e-3))
    step = steps.make_gspn_train_step(num_seeds=8, gt_size=16)
    sb = synthetic.scene_batch(np.random.default_rng(0), 2, n_points=N, max_instances=3,
                               extent=2.0)
    batch = {k: torch.from_numpy(v) for k, v in sb.items()}
    step(ts, batch, generator=torch.Generator().manual_seed(1))
    st = _stats()
    phases = ("train.forward", "train.backward", "train.optimizer")
    assert st["train.step"]["count"] == 1 and all(st[p]["count"] == 1 for p in phases)
    assert sum(st[p]["total_s"] for p in phases) <= st["train.step"]["total_s"]
    assert not any(k.endswith("@stream") for k in st)  # no stream times off the card
