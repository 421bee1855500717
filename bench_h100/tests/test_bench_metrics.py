"""The metric arithmetic: tails over every request, rates over the whole
window (a stall in it moves the rate), the per-layer readers and the
limits."""

from __future__ import annotations

import sys

import pytest

from tiny import ROOT

sys.path.insert(0, str(ROOT))

from bench_h100 import compare, readers, stats, trace, workcount  # noqa: E402


def test_p95_is_over_every_request():
    lat = [1.0] * 95 + [10.0] * 5
    assert stats.percentile(lat, 95) == 1.0
    assert stats.percentile(lat + [10.0], 95) == 10.0
    # not a median of chunks: one slow chunk of 10 in 200 moves the tail
    assert stats.percentile([1.0] * 190 + [50.0] * 10, 95) == 1.0
    assert stats.percentile([1.0] * 189 + [50.0] * 11, 95) == 50.0


def test_rate_is_over_the_whole_window_and_a_stall_moves_it():
    steady = stats.rate(1000 * 8192, 10.0)
    # the same requests with a 2 s stall in the window: the rate drops by
    # the stall's share, not by the requests' median
    stalled = stats.rate(1000 * 8192, 12.0)
    assert steady == pytest.approx(819200.0)
    assert stalled == pytest.approx(steady * 10 / 12)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def _ctx(kind="serve", gspn=0.4e-3, lib=6e-3, calls=30):
    win = trace.Window(calls=calls, wall_s=0.4, busy_s=0.3, gspn_s=gspn * calls,
                       library_s=lib * calls, top=[], gaps=[], complete=True)
    return {"kind": kind, "call_s": 9e-3, "window": win, "host_ms": 2.5,
            "matmul_flops": 45e9, "point_least_s": 0.1e-3}


def test_readers():
    ctx = _ctx()
    assert readers.mfu(ctx, "serve") == pytest.approx(100 * 45e9 / (9e-3 * 67e12))
    assert readers.mfu(ctx, "train") is None
    assert readers.device_ms(ctx, "serve", "gspn_s") == pytest.approx(0.4)
    assert readers.device_ms(ctx, "serve", "library_s") == pytest.approx(6.0)
    assert readers.kernel_roofline(ctx, "serve") == pytest.approx(25.0)
    assert readers.idle_share(ctx, "serve") == pytest.approx(25.0)
    # nothing to read: no hand-written kernel ran, so no roofline share (never 0)
    assert readers.kernel_roofline(_ctx(gspn=0.0), "serve") is None


def test_least_time_is_per_call_and_the_larger_roof():
    with workcount.counting() as t:
        workcount.point_op("a", 3.35e9, 1.0)  # bytes: 1 ms
        workcount.point_op("b", 1.0, 33.5e9)  # operations: 1 ms
        workcount.matmul(10, 4, 3)
    assert t.point_op_least_s() == pytest.approx(2e-3)
    assert t.matmul_flops == 240
    assert not workcount.counting_on()


def test_judge():
    ok, checks = compare.judge({"a": 1e-3, "b": 2.0}, {"a": 1e-2, "b": 1.0})
    assert not ok and checks["a"] == {"value": 1e-3, "limit": 1e-2}
    assert not compare.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert compare.judge({"a": 0.0}, {"a": 0.0})[0]


def test_train_numbers_leave_round_off_leaves_out_of_the_change():
    import torch

    g = {"w": torch.ones(4), "v": torch.ones(4), "b": torch.full((4,), 1e-9)}
    change = {"w": torch.ones(4), "v": torch.ones(4), "b": torch.ones(4)}
    got = {"w": torch.ones(4), "v": torch.ones(4), "b": -torch.ones(4) * 3}
    n = compare.train_numbers([1.0], [1.0], g, g, got, change, {"m": torch.ones(2)},
                              {"m": torch.ones(2)})
    assert n == {"loss_gap": 0.0, "first_loss_gap": 0.0, "grad_norm_gap": 0.0, "change_gap": 0.0,
                 "bn_stat_gap": 0.0}
    # a state left unchanged reads 1
    still = {k: torch.zeros(4) for k in change}
    assert compare.train_numbers([1.0], [1.0], g, g, still, change, {"m": torch.ones(2)},
                                 {"m": torch.ones(2)})["change_gap"] == pytest.approx(1.0)


class _SlowSession:
    """A session whose every request takes ``secs``; request ``bad`` raises."""

    def __init__(self, secs: float, bad: int = -1):
        self.secs, self.bad, self.calls = secs, bad, 0

    def predict(self, xyz, valid=None, seed=0):
        import time

        self.calls += 1
        if self.calls - 1 == self.bad:
            raise ValueError("a request that raises")
        time.sleep(self.secs)
        return {"i": self.calls}


def test_the_open_loop_stops_when_the_window_closes():
    from bench_h100 import serve

    pool = [{"xyz": None, "valid": None}]
    # 20 requests due a second, each taking 0.1 s on one client: over
    # capacity, so most requests due are never started, and none is failed
    res = serve.open_loop(_SlowSession(0.1, bad=2), pool, [0], 7, 0, 1.0, 20.0, 1)
    assert res["failed"] == 1
    assert 8 <= res["started"] <= 11
    assert res["next"] <= 20
    assert max(res["done"].values()) <= res["start"] + 1.0 + 0.15
    done, _, lat = serve.completed(res, [5], [0], 0, 1.0)
    assert done == len(lat) == len([t for t in res["done"].values()
                                    if t <= res["start"] + 1.0])


def test_the_check_sample_is_drawn_from_every_request_served():
    from bench_h100 import serve

    s = serve.Sample(2147483901)
    for i in range(2000):
        s.offer(i, {"i": i})
    assert sorted(s.answers()) == s.pick(2000)
    # not only the first requests of the window
    assert max(s.pick(2000)) > 256
    # the requests that were served, whichever they were
    t = serve.Sample(2147483901)
    for i in range(1, 2000, 2):
        t.offer(i, {"i": i})
    assert all(i % 2 for i in t.answers()) and len(t.answers()) == serve.CHECK_REQUESTS


@pytest.mark.parametrize("complete", [True, False])
def test_a_trace_that_lost_records_gives_no_result(monkeypatch, capsys, complete):
    import torch

    from bench_h100 import run, serve

    win = trace.Window(calls=40, wall_s=0.4, busy_s=0.3, gspn_s=0.016, library_s=0.24,
                       top=[["k", 0.1]], gaps=[["replay (3 gaps)", 0.01]], complete=complete)
    out = {"numbers": {"slot_mismatch": 0.0, "mask_mismatch": 0.0, "score_moved": 0.0,
                       "box_moved": 0.0},
           "layer": {"kind": "serve", "call_s": 9e-3, "window": win, "host_ms": 2.5,
                     "matmul_flops": 45e9, "point_least_s": 0.1e-3},
           "failed": 0, "attempted": 100, "memory_peak_bytes": 1, "setup_end": 1.0,
           "setup_parts": {}, "checked": ""}
    monkeypatch.setattr(serve, "run", lambda *a, **k: out)
    monkeypatch.setattr(run, "use_checkout_caches", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "a card")
    rc = run.main(["--workload", "scannet-serve-b8n8192", "--seed", "1", "--seconds", "1",
                   "--trace", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    if complete:
        assert rc == 0 and '"device_idle_share.serve"' in lines[-1]
    else:
        assert rc == 4 and not any(line.startswith("{") for line in lines)
