"""gspn_tpu_torch — the PyTorch / CUDA port of ``gspn_tpu``.

This package runs the fused instance-segmentation inference slice (GSPN
proposals -> NMS -> R-PointNet -> per-point masks) on an NVIDIA Hopper
card. Its layout mirrors the JAX package, which stays the reference:

- ``gspn_tpu_torch.ops``    — point ops; FPS, ball group, box group and
  three_nn run hand-written CUDA kernels (``csrc/``) on CUDA tensors and
  plain PyTorch versions on CPU tensors.
- ``gspn_tpu_torch.nn``     — shared MLPs, set abstraction, feature
  propagation.
- ``gspn_tpu_torch.models`` — GSPN, R-PointNet, the inference pipeline and
  presets.
- ``gspn_tpu_torch.serve``  — the exported serving artifact, its session
  (a CUDA graph a request on the card) and the socket server.
- ``gspn_tpu_torch.train``  — the two stages' trainers.
- ``gspn_tpu_torch.parallel`` — data-parallel training over
  ``torch.distributed``.
- ``gspn_tpu_torch.data``   — synthetic scenes, the ScanNet, ShapeNet and
  PartNet loaders and the host point-prep library (``csrc/pointprep.cpp``).
- ``gspn_tpu_torch.convert`` — JAX variables -> state dicts.

It imports ``torch`` and never ``jax``, ``flax`` or ``gspn_tpu``.
"""

__version__ = "0.1.0"
