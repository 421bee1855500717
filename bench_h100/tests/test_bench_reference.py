"""The plain reference against the port's plain path at a tiny size on the
CPU, and the frozen work counts against hand counts."""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch

from tiny import ROOT, tiny_tree

sys.path.insert(0, str(ROOT))

from bench_h100 import program, scenes, serve, train, workcount  # noqa: E402
from bench_h100.reference import model as ref  # noqa: E402
from bench_h100.reference import ops  # noqa: E402


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base, _ = tiny_tree(tmp_path_factory.mktemp("tiny") / "b")
    return base


def _load(base, sub, name):
    return json.loads((base / sub / f"{name}.json").read_text())


@pytest.mark.parametrize("traffic_name", ["serve-b8n8192", "serve-scene64k"])
def test_inference_equals_the_plain_path(tree, traffic_name):
    from gspn_tpu_torch.models.pipeline import PipelineModel, make_inference_fn

    cfg, traffic = _load(tree, "configs", "scannet-pipeline"), _load(tree, "traffic", traffic_name)
    dev = torch.device("cpu")
    state, pool, order = serve.inputs(cfg, traffic, 20260101, dev)
    pcfg = program.pipeline_config(cfg)
    model = PipelineModel(pcfg)
    model.load_state_dict(state)
    model.eval()
    infer = make_inference_fn(pcfg)
    for i in range(2):
        b = scenes.to_device(pool[order[i]], dev)
        z = serve.request_noise(serve.request_seed(7, i), (traffic["batch"], cfg["num_seeds"],
                                                            cfg["gspn"]["latent_dim"]))
        with torch.no_grad():
            got = infer(model, b["xyz"], b["valid"], z_eps=z)
            want = ref.infer(cfg, state, b["xyz"], b["valid"], z)
        assert want["valid"].any() and want["masks"].any()
        for f in ("masks", "valid", "classes"):
            assert torch.equal(getattr(got, f), want[f]), f
        torch.testing.assert_close(got.scores, want["scores"], rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(got.boxes, want["boxes"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("config_name,traffic_name", [("gspn-stage1", "train-b16"),
                                                      ("rpointnet-stage2", "train-b32")])
def test_training_steps_equal_the_plain_path(tree, config_name, traffic_name):
    """Three steps of the program's step on the CPU (its plain path) and of
    the reference, from the same weights, batches and draws: the losses
    and the first gradients agree to float32 rounding."""
    cfg, traffic = _load(tree, "configs", config_name), _load(tree, "traffic", traffic_name)
    dev = torch.device("cpu")
    state, frozen, pool, order = train.inputs(cfg, traffic, 99, dev)
    step, ts = program.train_step(cfg, state, frozen, dev)
    losses = []
    for i in range(train.CHECKED_STEPS):
        losses.append(float(step(pool[order[i]], train.step_generator(99, i, dev))["loss"]))
        if i == 0:
            first = program.first_gradient(ts)
    want = train.reference_steps(cfg, state, frozen, pool, order, 99, dev)
    np.testing.assert_allclose(losses, [float(w["loss"]) for w in want], rtol=1e-5)
    for k, g in want[0]["grads"].items():
        scale = max(float(g.norm()), 1e-3 * max(float(v.norm()) for v in want[0]["grads"].values()))
        assert float((first[k] - g).norm()) <= 1e-4 * scale, k


def _tiny_pipeline(tree):
    return _load(tree, "configs", "scannet-pipeline")


def test_matmul_count_is_the_hand_count(tree):
    """Every Dense product of one tiny request, counted by hand: rows x in x
    out x 2 (B=2 scenes, 16 seeds, crops K 8/16/16; R-PointNet SA 64 and
    16 centres of K 8, FP to 64 and 256 points, 16 RoIs of 8 samples)."""
    cfg = _tiny_pipeline(tree)
    traffic = _load(tree, "traffic", "serve-b8n8192")
    dev = torch.device("cpu")
    state, pool, order = serve.inputs(cfg, traffic, 5, dev)
    with workcount.counting() as t:
        serve.reference_answer(cfg, traffic, state, pool, order, 5, 0, dev)
    gspn = (512 * (3 * 8 + 8 * 16) + 32 * (16 * 16 + 16 * 3)  # centre encoder and FC
            + (256 + 512 + 512) * (3 * 8 + 8 * 16)  # the three crop encoders
            + 32 * (48 * 16) + 32 * (16 * 16 + 16 * 8)  # cond and prior
            + 32 * (20 * 16 + 16 * 48) + 32 * (16 * 8 + 8 * 1))  # generator, objectness
    rpn = (1024 * (3 * 8 + 8 * 16) + 256 * ((3 + 16) * 16 + 16 * 16)  # SA1, SA2
           + 128 * (32 * 16) + 512 * (16 * 16 + 16 * 16)  # FP1, FP2
           + 256 * ((3 + 16) * 8 + 8 * 16) + 32 * (16 * 16 + 16 * 4) + 32 * (16 * 16 + 16 * 6)
           + 256 * (32 * 8) + 256 * 8)  # RoI MLP, cls, box, mask MLP, mask out
    assert t.matmul_flops == 2 * (gspn + rpn)


def test_point_op_counts_are_the_hand_counts():
    xyz = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [0.05, 0, 0], [3, 0, 0], [0.02, 0, 0]]])
    valid = torch.ones((1, 5), dtype=torch.bool)
    with workcount.counting() as t:
        ops.fps_exact(xyz, 3, valid)
        ((idx, cnt, _),) = ops.ball_group((0.1,), (2,), xyz, xyz[:, :1], valid)
        boxes = torch.tensor([[[0.0, 0, 0, 1, 1, 1], [0.5, 0, 0, 1.5, 1, 1]]])
        ops.nms(boxes, torch.tensor([[0.9, 0.8]]), 0.25)
    names = [n for n, _, _ in t.point_ops]
    assert names == ["fps", "ball_group", "nms"]
    # FPS: (npoint - 1) passes over 5 points, 10 operations a point
    assert t.point_ops[0][2] == 2 * 5 * 10
    # the first 2 hits of the query at the origin are points 0 and 2: a
    # first-K scan reads 3 points, 8 + 1 operations each
    assert idx.tolist() == [[[0, 2]]] and cnt.tolist() == [[2]]
    assert t.point_ops[1][2] == 3 * 9
    # NMS: every pair of the 2 boxes, 20 operations a pair
    assert t.point_ops[2][2] == 4 * 20


def test_counts_do_not_change_with_the_programs_ops_impl(tree):
    """The counts come from the reference on the inputs: the program's
    choice of implementation (``ops_impl``) does not reach them."""
    base = _tiny_pipeline(tree)
    traffic = _load(tree, "traffic", "serve-b8n8192")
    dev = torch.device("cpu")
    tallies = []
    for impl in ("plain", "cuda", "auto"):
        cfg = json.loads(json.dumps(base))
        cfg["gspn"]["ops_impl"] = cfg["rpointnet"]["ops_impl"] = impl
        state, pool, order = serve.inputs(cfg, traffic, 5, dev)
        with workcount.counting() as t:
            serve.reference_answer(cfg, traffic, state, pool, order, 5, 0, dev)
        tallies.append((t.matmul_flops, t.point_ops))
    assert tallies[0] == tallies[1] == tallies[2]
