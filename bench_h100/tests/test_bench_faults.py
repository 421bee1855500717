"""A whole run of each cell kind, past the harness's look for a chip, on
the CPU at a tiny size: sound, it comes out correct; with the timed path
broken underneath, once for each fault the cell can have, ``correct``
comes out false. One chip, so there is no exchange between chips to
leave out."""

from __future__ import annotations

import sys

import pytest
import torch

from tiny import ROOT, tiny_tree

sys.path.insert(0, str(ROOT))

from bench_h100 import manifest, program, run, train  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tiny") / "b")


def _run(tree, cell: str, seed: int = 424242424242):
    base, man = tree
    return run.run_cell(man, manifest.workload(man, cell), seed, 1.0, False, CPU, 0.0,
                        base=base)


# the call or step from which a late fault sets in: past the warm-up and
# the first steps set-up checks, inside the window
LATE = 8
# the training window's steps: its last snapshot starts past LATE
WINDOW_STEPS = 16


class _Clock:
    """A clock that moves by a fixed tick at each reading, so that a
    training window holds the same steps however busy the host is."""

    def __init__(self, tick: float):
        self.now, self.tick = 0.0, tick

    def perf_counter(self) -> float:
        self.now += self.tick
        return self.now


class _Broken:
    """A session whose answers are altered where they are produced."""

    def __init__(self, session, fault: str):
        self.session, self.fault, self.calls = session, fault, 0

    def predict(self, xyz, valid=None, seed=0):
        self.calls += 1
        if self.fault == "half_batch":  # the second half answered as the first
            h = len(xyz) // 2
            xyz, valid = xyz.copy(), valid.copy()
            xyz[h:2 * h], valid[h:2 * h] = xyz[:h], valid[:h]
        out = self.session.predict(xyz, valid, seed=seed)
        if self.fault == "answer" or (self.fault == "late_answer" and self.calls > LATE):
            # the first scene's scores off by 1 %, a slot flipped
            out["scores"][0] *= 1.01
            out["valid"][0, 0] = ~out["valid"][0, 0]
        return out


@pytest.mark.parametrize("cell", ["scannet-serve-b8n8192", "scannet-serve-scene64k"])
@pytest.mark.parametrize("fault", [None, "answer", "half_batch", "late_answer"])
def test_serving_faults_come_out_incorrect(tree, monkeypatch, cell, fault):
    if fault is not None:
        real = program.session
        monkeypatch.setattr(program, "session",
                            lambda *a, **k: _Broken(real(*a, **k), fault))
    r = _run(tree, cell)
    assert r["correct"] is (fault is None), r["checks"]


@pytest.mark.parametrize("cell", ["gspn-train-b16", "rpointnet-train-b32"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "late_unchanged"])
def test_training_faults_come_out_incorrect(tree, monkeypatch, cell, fault):
    # the window's snapshots often enough that a short CPU window holds
    # several, the last of them past the late fault's start
    monkeypatch.setattr(train, "SNAPSHOT_EVERY", 4)
    monkeypatch.setattr(train, "time", _Clock(1.0 / WINDOW_STEPS))
    if fault is not None:
        real = program.train_step

        def broken(*a, **k):
            step, ts = real(*a, **k)
            if fault in ("unchanged", "late_unchanged"):  # the state left as it was
                saved, calls = {}, [0]

                def still(batch, generator):
                    calls[0] += 1
                    if fault == "unchanged" or calls[0] == LATE:
                        saved.update({k: v.clone() for k, v in ts.model.state_dict().items()})
                    out = step(batch, generator)
                    if saved:
                        ts.model.load_state_dict(saved)
                    return out
                return still, ts

            def half(batch, generator):  # half of the batch, the mean over the rest
                h = len(batch["xyz"]) // 2
                return step({k: v[:h] for k, v in batch.items()}, generator)
            return half, ts

        monkeypatch.setattr(program, "train_step", broken)
    r = _run(tree, cell)
    assert r["correct"] is (fault is None), r["checks"]
