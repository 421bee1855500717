"""The port's serving artifact (``gspn_tpu_torch.serve.export``): the
counterparts of ``tests/test_export.py``. A ``torch.export`` program of the
TINY pipeline, saved to one file and loaded back, reproduces the live
port bit for bit (exact and spatial segmented FPS); a wrong shape, an
unported knob, another platform and a file that is not an artifact are
refused; and the traced graph holds each kernel call as one opaque
``gspn::`` op, not a plain version's loop unrolled into ``aten`` calls.
CPU only: the artifact is exported for and run on ``cpu``."""

import collections
import dataclasses
import io
import json
import zipfile

import numpy as np
import pytest
import torch

from gspn_tpu_torch.data import synthetic
from gspn_tpu_torch.models import pipeline as tpl
from gspn_tpu_torch.models.presets import set_pipeline_fps_segments, set_pipeline_group_select
from gspn_tpu_torch.serve import export as sx
from tests.test_pipeline_eval import TINY
from tests.torch_parity import pipeline_config

B, N = 2, 192
CFG = pipeline_config(dataclasses.replace(TINY, mask_thresh=0.47))
SPATIAL = set_pipeline_fps_segments(dataclasses.replace(CFG, num_seeds=16), 2, "spatial")


def _model(cfg):
    model = tpl.PipelineModel(cfg)
    model.load_state_dict(tpl.init_pipeline_variables(cfg, torch.Generator().manual_seed(0), N))
    return model.eval()


def _inputs(cfg, seed=0, b=B, n=N):
    sb = synthetic.scene_batch(np.random.default_rng(seed), b, n_points=n, max_instances=3,
                               extent=2.0)
    eps = torch.randn((b, cfg.num_seeds, cfg.gspn.latent_dim),
                      generator=torch.Generator().manual_seed(seed + 1))
    return torch.from_numpy(sb["xyz"]), torch.from_numpy(sb["valid"]), eps


def _gspn_ops(program):
    return collections.Counter(
        str(node.target) for node in program.graph.nodes
        if node.op == "call_function" and str(node.target).startswith("gspn.")
    )


@pytest.mark.parametrize("case", ["exact_fps", "spatial_fps"])
def test_export_roundtrip_bit_identical(case, tmp_path):
    cfg = {"exact_fps": CFG, "spatial_fps": SPATIAL}[case]
    model = _model(cfg)
    xyz, valid, eps = _inputs(cfg)
    with torch.inference_mode():
        live = tpl.make_inference_fn(cfg)(model, xyz, valid, z_eps=eps)
    path = sx.save_artifact(tmp_path / "tiny.gspnt", sx.export_inference(
        cfg, model, N, batch_size=B, device="cpu"), cfg)
    program, manifest = sx.load_artifact(path, "cpu")
    assert manifest["format"] == sx.FORMAT and manifest["format_version"] == 1
    assert manifest["platforms"] == ["cpu"]
    assert manifest["inputs"] == {"xyz": [B, N, 3], "valid": [B, N],
                                  "z_eps": [B, cfg.num_seeds, cfg.gspn.latent_dim]}
    assert manifest["outputs"]["masks"] == [[B, cfg.num_seeds, N], "torch.bool"]
    assert manifest["pipeline_config"]["num_seeds"] == cfg.num_seeds
    # the artifact holds no weights: they are the program's first input
    assert not program.state_dict and path.stat().st_size < 200_000
    with torch.inference_mode():
        got = program.module()(sx.serving_state(model), xyz, valid, eps)
    for f, g in zip(tpl.PREDICTION_FIELDS, got, strict=True):
        assert torch.equal(g, getattr(live, f)), f
    m = got[0][got[4]]
    assert m.any() and not m.all()  # the masks comparison sees both outcomes


def test_export_rejects_wrong_shape(tmp_path):
    model = _model(CFG)
    program = sx.export_inference(CFG, model, N, batch_size=B, device="cpu")
    program, _ = sx.load_artifact(sx.save_artifact(tmp_path / "t.gspnt", program, CFG), "cpu")
    xyz, valid, eps = _inputs(CFG, n=N + 8)
    with pytest.raises(Exception, match=str(N)):
        program.module()(sx.serving_state(model), xyz, valid, eps)


def _rewrite_manifest(src, dst, **changes):
    with zipfile.ZipFile(src) as z:
        files = {name: z.read(name) for name in z.namelist()}
    manifest = json.loads(files["manifest.json"])
    manifest.update(changes)
    files["manifest.json"] = json.dumps(manifest).encode()
    with zipfile.ZipFile(dst, "w") as z:
        for name, data in files.items():
            z.writestr(name, data)
    return dst


def test_load_refuses_another_platform(tmp_path):
    """A ``cpu`` artifact does not load for the card, and one that names
    ``cuda`` does not load on the CPU (no card needed: the manifest
    decides before the program is read)."""
    path = sx.save_artifact(tmp_path / "cpu.gspnt", sx.export_inference(
        CFG, _model(CFG), N, batch_size=B, device="cpu"), CFG)
    with pytest.raises(ValueError, match=r"exported for \['cpu'\].*cuda"):
        sx.load_artifact(path, "cuda")
    card = _rewrite_manifest(path, tmp_path / "cuda.gspnt", platforms=["cuda"])
    with pytest.raises(ValueError, match=r"exported for \['cuda'\].*cpu"):
        sx.load_artifact(card, "cpu")
    newer = _rewrite_manifest(path, tmp_path / "v2.gspnt", format_version=2)
    with pytest.raises(ValueError, match="newer"):
        sx.load_artifact(newer, "cpu")


def test_load_rejects_non_artifact(tmp_path):
    other = tmp_path / "other.gspnt"
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("manifest.json", '{"format": "something-else"}')
        z.writestr("program.pt2", b"")
    other.write_bytes(buf.getvalue())
    with pytest.raises(ValueError, match="not a gspn_tpu_torch.serving artifact"):
        sx.load_artifact(other, "cpu")
    junk = tmp_path / "junk.gspnt"
    junk.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="not a gspn_tpu_torch.serving artifact"):
        sx.load_artifact(junk, "cpu")


def test_exported_graph_holds_one_op_per_kernel_call():
    """Each kernel call is one ``gspn::`` node: the FPS pass, the ball groups
    (GSPN crops, SA1, SA2), the box group, NMS, three_nn a FP level and the
    mask projection; and the graph does not grow with the FPS picks, as the
    plain pick loop would if it were traced (12 and 48 seeds, a shared pass
    of 32 and 48 picks, give the same nodes)."""
    sa = len(CFG.rpointnet.sa_layers)
    want = {"gspn.fps.default": sa, "gspn.ball_group.default": 1 + sa,
            "gspn.box_group.default": 1, "gspn.nms_3d_batched.default": 1,
            "gspn.three_nn.default": sa, "gspn.nearest_sample_logit.default": 1}
    sizes = []
    for cfg in (CFG, dataclasses.replace(CFG, num_seeds=48)):
        program = sx.export_inference(cfg, _model(cfg), N, batch_size=B, device="cpu")
        assert _gspn_ops(program) == want
        sizes.append(sum(node.op == "call_function" for node in program.graph.nodes))
    assert sizes[0] == sizes[1], sizes
    # the boxed projection, the grid RoIs, the 3nn masks and the strided
    # groups are registered ops too: each config exports
    for cfg, op in (
        (dataclasses.replace(SPATIAL, mask_project_prune="auto"),
         "gspn.nearest_sample_logit_boxed.default"),
        (dataclasses.replace(CFG, rpointnet=dataclasses.replace(CFG.rpointnet,
                                                                  roi_sample="grid")),
         "gspn.three_nn.default"),
        (dataclasses.replace(CFG, mask_project="3nn"), "gspn.three_nn.default"),
        (set_pipeline_group_select(CFG, "strided"), "gspn.ball_group.default"),
    ):
        assert _gspn_ops(sx.export_inference(cfg, _model(cfg), N, batch_size=B,
                                             device="cpu"))[op] >= 1
