"""A tiny copy of the benchmark's tree for the CPU tests: the same files,
with every configuration cut to a few points and narrow widths."""

from __future__ import annotations

import json
import pathlib
import shutil

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent

TINY_GSPN = {"context_radii": [0.25, 0.5, 1.0], "context_nsample": [8, 16, 16],
             "encoder_mlp": [8, 16], "center_mlp": [8, 16], "center_fc": [16], "latent_dim": 4,
             "cond_dim": 16, "generator_fc": [16], "num_gen_points": 16, "objectness_fc": [8]}
TINY_RPOINTNET = {"sa_layers": [[64, 0.4, 8, [8, 16]], [16, 0.8, 8, [16, 16]]],
                  "fp_mlps": [[16], [16, 16]], "roi_samples": 8, "roi_mlp": [8, 16],
                  "cls_fc": [16], "box_fc": [16], "mask_mlp": [8], "num_classes": 3}
TINY_TRAFFIC = {"serve": {"batch": 2, "points": 256, "pool": 3, "rate": 40.0, "clients": 2},
                "train": {"batch": 2, "points": 256, "pool": 4}}


def tiny_tree(dst: pathlib.Path) -> tuple[pathlib.Path, dict]:
    """Copy ``bench_h100``'s configuration, traffic and metric files to
    ``dst`` with tiny sizes; returns ``(dst, the manifest)``."""
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(HERE / sub, dst / sub)
    for path in (dst / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["gspn"].update(TINY_GSPN)
        if "rpointnet" in cfg:
            cfg["rpointnet"].update(TINY_RPOINTNET)
        if cfg["kind"] == "pipeline":
            cfg["num_seeds"] = 16
            cfg["gspn"]["fps_segments"] = cfg["rpointnet"]["fps_segments"] = 2
        else:
            cfg["train"].update(num_seeds=16, gt_size=16, max_instances=4)
        path.write_text(json.dumps(cfg))
    for path in (dst / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(TINY_TRAFFIC["serve" if path.name.startswith("serve") else "train"])
        t["room"]["max_instances"] = 4
        path.write_text(json.dumps(t))
    return dst, json.loads((ROOT / "BENCHMARK.json").read_text())
