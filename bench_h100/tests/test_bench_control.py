"""On the card, at each cell's own size: the control (the reference in the
program's place, with TF32 matmuls, the nearest precision below the
configurations' float32 with TF32 off) comes out not correct, on three
seeds; so does a training cell with half of each batch left out. A
training cell's three steps from inside the window are held the same way,
from the snapshot a short program run takes."""

from __future__ import annotations

import sys

import pytest

from tiny import ROOT

sys.path.insert(0, str(ROOT))

from bench_h100 import calibrate, compare, manifest, train  # noqa: E402

MAN = manifest.load(ROOT)
SEEDS = (2147483901, 2147483902, 2147483903)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size on the card")
    return torch.device("cuda", 0)


def _judge(numbers: dict, limits: dict):
    """``compare.judge`` over the limits of the numbers given."""
    return compare.judge(numbers, {k: v for k, v in limits.items() if k in numbers})


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_the_control_is_not_correct(cuda, cell):
    w = manifest.workload(MAN, cell)
    cfg, traffic = manifest.config(w["config"]), manifest.traffic(w["traffic"])
    limits = manifest.limits(cell)
    for seed in SEEDS:
        ok, checks = _judge(calibrate.control_numbers(cfg, traffic, seed, cuda), limits)
        assert not ok, (seed, checks)
        if cfg["kind"] != "pipeline":
            ok, checks = _judge(calibrate.half_batch_numbers(cfg, traffic, seed, cuda), limits)
            assert not ok, (seed, checks)
            keep: dict = {}
            with calibrate.tf32(False):
                train.run(cfg, traffic, seed, 2.0, False, cuda, keep=keep)
            for name, nums in calibrate.window_numbers(cfg, traffic, seed, cuda, keep).items():
                ok, checks = _judge(nums, limits)
                assert not ok, (seed, name, checks)
