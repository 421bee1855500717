"""3D axis-aligned-box NMS on the device.

Counterpart of ``gspn_tpu/ops/nms.py``: a stable descending score sort, one
IoU matrix, then greedy suppression over the sorted boxes. Boxes are
``[xmin, ymin, zmin, xmax, ymax, zmax]``.

``impl`` picks the suppression:

- ``"cuda"``: the sequential greedy kernel ``csrc/nms.cu`` (the TPU's
  ``_nms_kernel``), up to ``MAX_R`` boxes a scene; a CPU tensor raises.
- ``"plain"``: the Jacobi fixpoint loop (:func:`_suppress_jacobi`), on any
  device; it syncs the host every 8 steps.
- ``"auto"``: as in ``ops/common.py``, the kernel for a CUDA tensor and the
  Jacobi loop for a CPU tensor (the JAX package's ``auto`` is its XLA loop
  on every device; the two give the same keep mask).

The sort, the gather and :func:`box_iou` run in PyTorch on either route, as
the JAX package runs them in XLA.
"""

from __future__ import annotations

import torch

from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.ops.common import resolve_impl

KERNEL = _cuda.KERNELS["nms"]
# Boxes per scene the kernel route takes. The kernel's alive flags (R bytes
# of shared memory) would allow ~227k; the (B, R, R) float32 IoU matrix
# comes first: 4 GiB a scene at R = 32768, and box_iou's intermediates
# hold about ten such matrices at once, ~43 GB of an 80 GB card.
MAX_R = 32768


def box_volume(boxes: torch.Tensor) -> torch.Tensor:
    ext = torch.clamp(boxes[..., 3:6] - boxes[..., 0:3], min=0.0)
    return ext[..., 0] * ext[..., 1] * ext[..., 2]


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between ``a (..., Ra, 6)`` and ``b (..., Rb, 6)`` -> (..., Ra, Rb)."""
    lo = torch.maximum(a[..., :, None, 0:3], b[..., None, :, 0:3])
    hi = torch.minimum(a[..., :, None, 3:6], b[..., None, :, 3:6])
    ext = torch.clamp(hi - lo, min=0.0)
    inter = ext[..., 0] * ext[..., 1] * ext[..., 2]
    union = box_volume(a)[..., :, None] + box_volume(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def _suppress_jacobi(iou: torch.Tensor, alive: torch.Tensor, iou_thresh: float):
    """Greedy suppression over score-sorted ``iou (B,R,R)`` as the fixpoint
    of ``keep(i) = alive(i) and not any(j < i: keep(j), iou(j,i) > th)``.
    Entries of suppression-chain depth d settle after d steps; 8 steps run
    between convergence checks (each check is one host sync)."""
    r = iou.shape[-1]
    ar = torch.arange(r, device=iou.device)
    earlier = ar[:, None] < ar[None, :]  # j < i at [j, i]
    sup = (iou > iou_thresh) & earlier  # (B, R, R): j suppresses i

    def step(keep):
        return alive & ~(sup & keep[:, :, None]).any(dim=1)

    keep, prev, it = alive, ~alive, 0
    while bool((keep != prev).any()) and it <= r:
        for _ in range(7):
            keep = step(keep)
        prev, keep = keep, step(keep)
        it += 8
    return keep


def _suppress_cuda(iou: torch.Tensor, alive: torch.Tensor, iou_thresh: float):
    """:func:`_suppress_jacobi`'s result from the sequential kernel."""
    b, r, _ = iou.shape
    iou = iou.contiguous()
    a = alive.to(torch.uint8).contiguous()
    _cuda.check_cuda_input("iou", iou, torch.float32, (b, r, r))
    _cuda.check_cuda_input("alive", a, torch.uint8, (b, r))
    keep = torch.empty((b, r), dtype=torch.uint8, device=iou.device)
    if b and r:
        KERNEL.launch(iou.device, _cuda.ptr(iou), _cuda.ptr(a), b, r, float(iou_thresh),
                      _cuda.ptr(keep))
    return keep.bool()


def nms_3d_batched(boxes, scores, iou_thresh: float, valid=None, *, impl: str = "auto"):
    """Batched greedy NMS: ``(B,R,6), (B,R) -> keep (B,R)`` bool in the
    original box order; ``valid (B,R)`` boxes only are kept."""
    choice = resolve_impl(impl, boxes)
    if choice == "cuda" and boxes.shape[-2] > MAX_R:
        raise ValueError(
            f"the NMS kernel route takes at most {MAX_R} boxes per scene (its (B, R, R) "
            f"IoU matrix), got {boxes.shape[-2]}"
        )
    s = scores if valid is None else torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.sort(-s, dim=-1, stable=True).indices  # ties keep input order
    bs = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 6))
    alive = (
        torch.ones_like(scores, dtype=torch.bool)
        if valid is None
        else torch.gather(valid, 1, order)
    )
    iou = box_iou(bs, bs)
    if choice == "cuda":
        keep_sorted = _suppress_cuda(iou, alive, iou_thresh)
    else:
        keep_sorted = _suppress_jacobi(iou, alive, iou_thresh)
    return torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)


def nms_3d(boxes, scores, iou_thresh: float, valid=None, *, impl: str = "auto"):
    """Single-scene greedy NMS: ``(R,6), (R,) -> keep (R,)`` bool in the
    original box order."""
    keep = nms_3d_batched(
        boxes[None], scores[None], iou_thresh, None if valid is None else valid[None], impl=impl
    )
    return keep[0]
