"""Evaluation: ScanNet-protocol instance-segmentation AP (the port's
counterpart of ``gspn_tpu/eval``; ``python -m gspn_tpu_torch.eval.run_eval``
drives it)."""

from gspn_tpu_torch.eval.instance_eval import (
    SceneGT,
    ScenePredictions,
    evaluate_instances,
    gt_from_labels,
    predictions_from_device,
)

__all__ = [
    "SceneGT",
    "ScenePredictions",
    "evaluate_instances",
    "gt_from_labels",
    "predictions_from_device",
]
