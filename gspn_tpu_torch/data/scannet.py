"""ScanNet-v2 data pipeline: the port's copy of ``gspn_tpu/data/scannet.py``.

Two layers:

1. **Offline prep** (:func:`preprocess_scene`, driven by
   ``python -m gspn_tpu_torch.data.preprocess_scannet``): raw scan directory
   (``*_vh_clean_2.ply`` + ``*_vh_clean_2.0.010000.segs.json`` +
   ``*.aggregation.json``) -> per-point xyz/rgb/semantic/instance arrays,
   saved as one ``.npz`` per scene.
2. **Train-time loading** (:class:`ScanNetCrops`): fixed-size random crops
   (spatial blocks or whole-scene subsampling) with padding masks, batched
   into the same dict layout the synthetic generator produces.

The 18 ScanNet benchmark classes are the default semantic id space
(1..18, 0 = unlabeled/background).
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from gspn_tpu_torch.data import native
from gspn_tpu_torch.data.ply import read_ply_vertices

# ScanNet benchmark: 18 instance classes (nyu40 ids) in benchmark order.
BENCHMARK_CLASS_NAMES = (
    "cabinet", "bed", "chair", "sofa", "table", "door", "window",
    "bookshelf", "picture", "counter", "desk", "curtain", "refrigerator",
    "shower curtain", "toilet", "sink", "bathtub", "otherfurniture",
)
NYU40_TO_BENCH = {
    3: 1, 4: 2, 5: 3, 6: 4, 7: 5, 8: 6, 9: 7, 10: 8, 11: 9, 12: 10,
    14: 11, 16: 12, 24: 13, 28: 14, 33: 15, 34: 16, 36: 17, 39: 18,
}
# common raw-label-string -> nyu40 id shortcuts for aggregation files that
# carry strings; a full scannetv2-labels.combined.tsv can override this.
RAW_TO_NYU40 = {
    "cabinet": 3, "bed": 4, "chair": 5, "sofa": 6, "couch": 6, "table": 7,
    "door": 8, "window": 9, "bookshelf": 10, "picture": 11, "counter": 12,
    "desk": 14, "curtain": 16, "refrigerator": 24, "refridgerator": 24,
    "shower curtain": 28, "toilet": 33, "sink": 34, "bathtub": 36,
    "otherfurniture": 39,
}


def load_label_tsv(path: str) -> dict[str, int]:
    """Parse scannetv2-labels.combined.tsv -> raw name -> nyu40 id."""
    mapping = {}
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        raw_i = header.index("raw_category")
        nyu_i = header.index("nyu40id")
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) > max(raw_i, nyu_i) and parts[nyu_i]:
                mapping[parts[raw_i]] = int(parts[nyu_i])
    return mapping


def preprocess_scene(
    scan_dir: str | pathlib.Path,
    label_map: dict[str, int] | None = None,
) -> dict[str, np.ndarray]:
    """Raw ScanNet scan dir -> {xyz, rgb, sem_label, inst_label} arrays.

    sem_label is in benchmark space (0..18); instances not in the 18
    classes get inst_label 0 (background), matching the benchmark protocol.
    """
    scan_dir = pathlib.Path(scan_dir)
    scene_id = scan_dir.name
    mesh = read_ply_vertices(str(scan_dir / f"{scene_id}_vh_clean_2.ply"))
    xyz = np.stack([mesh["x"], mesh["y"], mesh["z"]], 1).astype(np.float32)
    if "red" in mesh:
        rgb = np.stack([mesh["red"], mesh["green"], mesh["blue"]], 1)
        rgb = rgb.astype(np.float32) / 255.0
    else:
        rgb = np.zeros((len(xyz), 3), np.float32)

    with open(scan_dir / f"{scene_id}_vh_clean_2.0.010000.segs.json") as f:
        seg_to_verts = np.asarray(json.load(f)["segIndices"], np.int64)
    with open(scan_dir / f"{scene_id}.aggregation.json") as f:
        agg = json.load(f)

    label_map = label_map or RAW_TO_NYU40
    n = len(xyz)
    sem = np.zeros(n, np.int32)
    inst = np.zeros(n, np.int32)
    next_inst = 1
    for group in agg["segGroups"]:
        raw = group["label"]
        nyu = label_map.get(raw, 0)
        bench = NYU40_TO_BENCH.get(nyu, 0)
        if bench == 0:
            continue
        members = np.isin(seg_to_verts, np.asarray(group["segments"]))
        sem[members] = bench
        inst[members] = next_inst
        next_inst += 1
    return {"xyz": xyz, "rgb": rgb, "sem_label": sem, "inst_label": inst}


def preprocess_to_npz(scan_dir, out_dir, label_map=None):
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    arrays = preprocess_scene(scan_dir, label_map)
    out = out_dir / f"{pathlib.Path(scan_dir).name}.npz"
    np.savez_compressed(out, **arrays)
    return out


class ScanNetCrops:
    """Preprocessed-scene loader producing fixed-shape crop batches.

    Crop policy (reference parity): whole-scene random subsample when the
    scene fits, else a random spatial block of ``block_size`` meters,
    subsampled/padded to ``num_points``. Instance ids are compacted to
    1..K within each crop. ``impl``: the point-prep route
    (``data/native.py``); the subsample's draw depends on it.
    """

    def __init__(
        self,
        npz_dir: str,
        num_points: int = 4096,
        block_size: float = 3.0,
        use_rgb: bool = True,
        morton: bool = False,
        impl: str = "auto",
    ):
        self.paths = sorted(pathlib.Path(npz_dir).glob("*.npz"))
        if not self.paths:
            raise FileNotFoundError(f"no .npz scenes under {npz_dir}")
        self.num_points = num_points
        self.block_size = block_size
        self.use_rgb = use_rgb
        # Morton-sort each crop's points on the host: a spatially coherent
        # point order lets the group kernels' AABB tiles prune. Point order
        # is a layout choice: first-K ball and box sampling then draws
        # other (equally valid) neighbour subsets, as any order would.
        self.morton = morton
        self.impl = impl
        if impl not in native.IMPLS:
            raise ValueError(f"impl must be auto|native|plain, got {impl!r}")
        self._cache: dict[int, dict] = {}

    def __len__(self):
        return len(self.paths)

    def _load(self, i: int) -> dict:
        if i not in self._cache:
            with np.load(self.paths[i]) as z:
                self._cache[i] = {k: z[k] for k in z.files}
        return self._cache[i]

    def crop(self, rng: np.random.Generator, i: int) -> dict:
        """Block crop, subsample, optional Morton order, pack and compact
        the instance ids, on the ``impl`` route of ``data/native.py``."""
        impl = self.impl
        sc = self._load(i)
        xyz = sc["xyz"]
        n = len(xyz)
        if n > self.num_points * 2:
            # spatial block around a random point
            center = xyz[rng.integers(0, n)]
            idx = native.block_crop_xy(
                xyz, float(center[0]), float(center[1]), self.block_size / 2, impl
            )
            if len(idx) < 32:  # degenerate block: fall back to whole scene
                idx = np.arange(n, dtype=np.int64)
        else:
            idx = np.arange(n, dtype=np.int64)
        if len(idx) > self.num_points:
            idx = native.subsample(
                idx, self.num_points, int(rng.integers(1, 2**63 - 1)), impl
            )
        if self.morton:
            idx = native.morton_order(xyz, idx, impl)
        feats = (
            sc["rgb"] if self.use_rgb and "rgb" in sc else None
        )
        out_xyz, out_feats, sem, inst, valid = native.gather_pack(
            xyz, feats, sc["sem_label"], sc["inst_label"], idx, self.num_points, impl
        )
        inst, _ = native.compact_instance_ids(inst, impl)
        return {
            "xyz": out_xyz,
            "features": out_feats,
            "valid": valid,
            "sem_label": sem,
            "inst_label": inst,
        }

    def sample_batch(self, rng: np.random.Generator, batch: int) -> dict:
        """Batch of crops. ``scene_ids`` (list of str, the source .npz
        stem, e.g. ``scene0707_00``) rides along for the official
        submission export; ``iterator.to_device`` leaves it on the host."""
        idx = [int(rng.integers(0, len(self.paths))) for _ in range(batch)]
        crops = [self.crop(rng, i) for i in idx]
        out = {k: np.stack([c[k] for c in crops]) for k in crops[0]}
        out["scene_ids"] = [self.paths[i].stem for i in idx]
        return out
