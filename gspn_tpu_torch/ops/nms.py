"""3D axis-aligned-box NMS on the device.

Counterpart of ``gspn_tpu/ops/nms.py``'s default path: a stable descending
score sort, one IoU matrix, then Jacobi fixpoint suppression. Boxes are
``[xmin, ymin, zmin, xmax, ymax, zmax]``. The TPU's sequential suppression
kernel (``_nms_kernel``) is a cross-check there and is not ported yet
(ROADMAP queue 2).
"""

from __future__ import annotations

import torch


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


def nms_3d_batched(boxes, scores, iou_thresh: float, valid=None):
    """Batched greedy NMS: ``(B,R,6), (B,R) -> keep (B,R)`` bool in the
    original box order."""
    s = scores if valid is None else torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.sort(-s, dim=-1, stable=True).indices  # ties keep input order
    bs = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 6))
    alive = (
        torch.ones_like(scores, dtype=torch.bool)
        if valid is None
        else torch.gather(valid, 1, order)
    )
    keep_sorted = _suppress_jacobi(box_iou(bs, bs), alive, iou_thresh)
    return torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)
