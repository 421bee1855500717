"""3D axis-aligned-box NMS on the device.

Counterpart of ``gspn_tpu/ops/nms.py``: a stable descending score sort, one
IoU matrix, then greedy suppression over the sorted boxes. Boxes are
``[xmin, ymin, zmin, xmax, ymax, zmax]``.

``impl`` picks the suppression:

- ``"cuda"``: one launch of ``csrc/nms.cu`` (the TPU's ``_nms_kernel``),
  which ranks the scores, computes the IoU as a suppression bitmask and
  sweeps it greedily, up to ``MAX_R`` boxes a scene; above ``SORT_MAX``
  boxes the scores are sorted here first. A CPU tensor raises.
- ``"plain"``: the Jacobi fixpoint loop (:func:`_suppress_jacobi`), on any
  device; it syncs the host every 8 steps.
- ``"auto"``: as in ``ops/common.py``, the kernel for a CUDA tensor and the
  Jacobi loop for a CPU tensor (the JAX package's ``auto`` is its XLA loop
  on every device; the two give the same keep mask).

On the plain route the sort, the gather and :func:`box_iou` run in PyTorch,
as the JAX package runs them in XLA; the kernel reproduces them bitwise.
"""

from __future__ import annotations

import torch

from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.ops.common import gspn_op, resolve_impl

KERNEL = _cuda.KERNELS["nms"]
# Boxes per scene the kernel route takes: the kernel keeps the sweep's
# suppressed bits of MAX_R boxes in dynamic shared memory (16 KB), and the
# mask above ONE_CTA_R boxes is a device buffer of R * ceil(R / 64) words,
# 2 GiB a scene at R = 131072.
MAX_R = 131072
SORT_MAX = 1024  # boxes the kernel ranks itself; above, torch.sort here
ONE_CTA_R = 128  # boxes one CTA takes with its mask in shared memory


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


def _nms_cuda(boxes, scores, valid, iou_thresh: float):
    """:func:`nms_3d_batched`'s keep mask from one kernel launch (and, above
    ``SORT_MAX`` boxes, the score sort before it; above ``ONE_CTA_R``, a
    zeroed count of finished CTAs a scene)."""
    b, r = scores.shape
    dev = boxes.device
    boxes = boxes.contiguous()
    scores = scores.contiguous()
    _cuda.check_cuda_input("boxes", boxes, torch.float32, (b, r, 6))
    _cuda.check_cuda_input("scores", scores, torch.float32, (b, r))
    v = None
    if valid is not None:
        v = _cuda.flag_bytes(valid)
        _cuda.check_cuda_input("valid", v, torch.uint8, (b, r))
    order = mask = counter = None
    if r > SORT_MAX:
        order = _score_order(scores, valid).contiguous()
    if r > ONE_CTA_R:
        mask = torch.empty((b, r, -(-r // 64)), dtype=torch.int64, device=dev)
        counter = torch.zeros((b,), dtype=torch.int32, device=dev)
    keep = torch.empty((b, r), dtype=torch.bool, device=dev)
    if b and r:
        KERNEL.launch(dev, _cuda.ptr(boxes), _cuda.ptr(scores), _cuda.ptr(v), _cuda.ptr(order),
                      b, r, float(iou_thresh), _cuda.ptr(mask), _cuda.ptr(counter),
                      _cuda.ptr(keep))
    return keep


def _score_order(scores, valid):
    """The stable descending score order, invalid boxes at -inf (NaN last)."""
    s = scores if valid is None else torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    return torch.sort(-s, dim=-1, stable=True).indices  # ties keep input order


def nms_3d_batched(boxes, scores, iou_thresh: float, valid=None, *, impl: str = "auto"):
    """Batched greedy NMS: ``(B,R,6), (B,R) -> keep (B,R)`` bool in the
    original box order; ``valid (B,R)`` boxes only are kept."""
    return _nms_op(boxes, scores, valid, float(iou_thresh), impl)


@gspn_op("nms_3d_batched")
def _nms_op(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor | None,
            iou_thresh: float, impl: str) -> torch.Tensor:
    """:func:`nms_3d_batched` as one opaque op: the kernel, or the plain
    version's Jacobi loop, which reads its convergence on the host."""
    choice = resolve_impl(impl, boxes)
    if choice == "cuda" and boxes.shape[-2] > MAX_R:
        raise ValueError(
            f"the NMS kernel route takes at most {MAX_R} boxes per scene (the sweep's "
            f"suppressed bits in shared memory), got {boxes.shape[-2]}"
        )
    if choice == "cuda":
        return _nms_cuda(boxes, scores, valid, iou_thresh)
    order = _score_order(scores, valid)
    bs = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 6))
    alive = (
        torch.ones_like(scores, dtype=torch.bool)
        if valid is None
        else torch.gather(valid, 1, order)
    )
    keep_sorted = _suppress_jacobi(box_iou(bs, bs), alive, iou_thresh)
    return torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)


@torch.library.register_fake(_nms_op)
def _(boxes, scores, valid, iou_thresh, impl):
    return scores.new_empty(scores.shape, dtype=torch.bool)


def nms_3d(boxes, scores, iou_thresh: float, valid=None, *, impl: str = "auto"):
    """Single-scene greedy NMS: ``(R,6), (R,) -> keep (R,)`` bool in the
    original box order."""
    keep = nms_3d_batched(
        boxes[None], scores[None], iou_thresh, None if valid is None else valid[None], impl=impl
    )
    return keep[0]
