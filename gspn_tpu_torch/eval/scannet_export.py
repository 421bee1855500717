"""Official ScanNet instance-segmentation submission format.

The port's own copy of ``gspn_tpu/eval/scannet_export.py``: the same
files, byte for byte.

The reference's eval flow dumps per-scene instance predictions that the
official ``evaluate_semantic_instance.py`` consumes (SURVEY.md §2.2,
inference and eval). That public format is:

- ``<out_dir>/<scene_id>.txt`` — one line per predicted instance:
  ``<relative mask path> <semantic label id> <confidence>``
- ``<out_dir>/predicted_masks/<scene_id>_<iii>.txt`` — the instance's
  per-point binary mask, one ``0``/``1`` per line, in scene point order.

Writers/readers here round-trip :class:`~gspn_tpu_torch.eval.instance_eval.
ScenePredictions`, so dumps produced with ``run_eval --dump-format
scannet`` are directly consumable by the official evaluator (and by our
own reader for offline re-scoring).
"""

from __future__ import annotations

import pathlib

import numpy as np

from gspn_tpu_torch.eval.instance_eval import ScenePredictions

# The 18 ScanNet benchmark instance classes (model class 1..18, in the
# benchmark's canonical order) -> NYU40 semantic label ids used by the
# official submission format.
SCANNET_BENCHMARK_LABEL_IDS: dict[int, int] = {
    i + 1: nyu
    for i, nyu in enumerate(
        (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)
    )
}
_ID_TO_CLASS = {v: k for k, v in SCANNET_BENCHMARK_LABEL_IDS.items()}

MASK_DIR = "predicted_masks"


def write_scannet_submission(
    out_dir: str | pathlib.Path,
    scene_id: str,
    pred: ScenePredictions,
    label_map: dict[int, int] | None = None,
) -> pathlib.Path:
    """Write one scene's predictions in the official submission layout.

    ``label_map`` maps model class ids to the submission's semantic label
    ids (defaults to the 18-class ScanNet benchmark NYU40 mapping; model
    classes missing from the map are written verbatim).

    Returns the scene's top-level ``.txt`` path.
    """
    label_map = SCANNET_BENCHMARK_LABEL_IDS if label_map is None else label_map
    out_dir = pathlib.Path(out_dir)
    mask_dir = out_dir / MASK_DIR
    mask_dir.mkdir(parents=True, exist_ok=True)
    lines = []
    for i in range(len(pred.scores)):
        rel = f"{MASK_DIR}/{scene_id}_{i:03d}.txt"
        mask = np.asarray(pred.masks[i]).astype(np.int8)
        np.savetxt(mask_dir / f"{scene_id}_{i:03d}.txt", mask, fmt="%d")
        cls = int(pred.classes[i])
        label = int(label_map.get(cls, cls))
        lines.append(f"{rel} {label} {float(pred.scores[i]):.6f}")
    scene_path = out_dir / f"{scene_id}.txt"
    scene_path.write_text("\n".join(lines) + ("\n" if lines else ""))
    return scene_path


def read_scannet_submission(
    out_dir: str | pathlib.Path,
    scene_id: str,
    label_map: dict[int, int] | None = None,
) -> ScenePredictions:
    """Read one scene back from the official layout (inverse of
    :func:`write_scannet_submission`; unknown semantic label ids are
    kept verbatim as class ids)."""
    id_to_class = (
        _ID_TO_CLASS
        if label_map is None
        else {v: k for k, v in label_map.items()}
    )
    out_dir = pathlib.Path(out_dir)
    masks, scores, classes = [], [], []
    text = (out_dir / f"{scene_id}.txt").read_text()
    for line in text.splitlines():
        if not line.strip():
            continue
        rel, label, conf = line.split()
        mask = np.loadtxt(out_dir / rel, dtype=np.int64, ndmin=1) != 0
        masks.append(mask)
        classes.append(id_to_class.get(int(label), int(label)))
        scores.append(float(conf))
    n = masks[0].shape[0] if masks else 0
    return ScenePredictions(
        masks=np.asarray(masks, bool).reshape(len(masks), n),
        scores=np.asarray(scores, np.float64),
        classes=np.asarray(classes, np.int64),
    )
