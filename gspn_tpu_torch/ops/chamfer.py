"""Bidirectional nearest-neighbour (chamfer) distance: ``nn_distance``.

Counterpart of ``gspn_tpu/ops/chamfer.py``. The argmin indices come from a
non-differentiable search on detached inputs (``nn_argmin_pair``: CUDA
route ``csrc/chamfer.cu``, both directions in one launch; plain route a
masked distance matrix and ``argmin`` each way), and the
distances are recomputed as a differentiable gather,
``((xyz1 - xyz2[idx1])**2).sum(-1)``, so autograd gives the reference's
analytic gradients (2(x - y) into ``xyz1``, the negated scatter-add into
``xyz2``, added in a fixed order by ``gather_point``'s backward) with no
custom backward.
"""

from __future__ import annotations

import torch

from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.ops.common import gspn_op, masked_sqdist, resolve_impl, sqdist_components
from gspn_tpu_torch.ops.grouping import gather_point

KERNEL = _cuda.KERNELS["nn_argmin"]


# nn_argmin_plan: the kernel's targets a CTA and pass and its most CTAs a
# row (csrc/chamfer.cu kTargets, kMaxSplit)
NN_ARGMIN_TARGETS = 256
NN_ARGMIN_MAX_SPLIT = 16


def nn_argmin_plan(n: int) -> int:
    """The two-way kernel's CTAs a row for rows of ``n`` targets: a CTA
    takes 256 targets a pass, so a CTA a 256-target tile, at most 16; a
    row of more tiles than that takes several passes a CTA."""
    return max(1, min(-(-n // NN_ARGMIN_TARGETS), NN_ARGMIN_MAX_SPLIT))


# the two-way kernel's per-row counts: zeroed once a (device, stream) and
# left zero by every launch, so that a call needs no fill (one device
# operation); a stream of its own each, so that launches on two streams do
# not share them
_DONE: dict = {}


def _done_counts(device, rows: int) -> torch.Tensor:
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _DONE.get(key)
    if buf is None or buf.numel() < rows:
        buf = _DONE[key] = torch.zeros(max(rows, 256), dtype=torch.int32, device=device)
    return buf


def _argmin_plain(a, b, b_valid):
    """Masked squared distances, first-occurrence argmin: padded sources
    count as 1e10, ties go to the lowest index."""
    return masked_sqdist(a, b, b_valid).argmin(dim=-1).to(torch.int32)


def _argmin_cuda(a, b, a_valid, b_valid, both: bool, ctas=None):
    """The kernel: ``a``'s nearest ``b`` and, when ``both``, ``b``'s nearest
    ``a``, in one launch (at ``ctas`` CTAs a row, or
    ``nn_argmin_plan``'s)."""
    bsz, n, _ = a.shape
    m = b.shape[1]
    a = a.contiguous()
    b = b.contiguous()
    _cuda.check_cuda_input("xyz1", a, torch.float32, (bsz, n, 3))
    _cuda.check_cuda_input("xyz2", b, torch.float32, (bsz, m, 3))
    flags = []
    for name, v, size in (("valid1", a_valid if both else None, n), ("valid2", b_valid, m)):
        if v is not None:
            v = _cuda.flag_bytes(v)
            _cuda.check_cuda_input(name, v, torch.uint8, (bsz, size))
        flags.append(v)
    idx1 = torch.empty((bsz, n), dtype=torch.int32, device=a.device)
    idx2 = torch.empty((bsz, m), dtype=torch.int32, device=a.device) if both else None
    ctas = nn_argmin_plan(n) if ctas is None else ctas
    # a row over several tiles: each CTA's column partials (distance and
    # index) in one scratch, and the row's count of finished CTAs
    scratch = done = None
    if both and n > NN_ARGMIN_TARGETS:
        scratch = torch.empty(2 * ctas * bsz * m, dtype=torch.float32, device=a.device)
        done = _done_counts(a.device, bsz)
    if bsz and n and m:
        KERNEL.launch(a.device, _cuda.ptr(a), _cuda.ptr(b), _cuda.ptr(flags[0]),
                      _cuda.ptr(flags[1]), bsz, n, m, ctas, _cuda.ptr(idx1), _cuda.ptr(idx2),
                      _cuda.ptr(scratch), _cuda.ptr(done))
    return (idx1, idx2) if both else idx1


def nn_argmin(xyz1, xyz2, valid2=None, *, impl: str = "auto") -> torch.Tensor:
    """Index of the nearest valid ``xyz2 (B,M,3)`` point for every ``xyz1
    (B,N,3)`` point, ``(B, N)`` int32, by squared distance; padded sources
    (``valid2 (B,M)`` False) count as 1e10, ties go to the lowest index.
    Not differentiable."""
    if xyz2.shape[1] == 0:
        raise ValueError("nn_argmin needs at least one source point")
    return _nn_argmin_op(xyz1, xyz2, valid2, impl)


@gspn_op("nn_argmin")
def _nn_argmin_op(xyz1: torch.Tensor, xyz2: torch.Tensor, valid2: torch.Tensor | None,
                  impl: str) -> torch.Tensor:
    """:func:`nn_argmin` as one opaque op."""
    if resolve_impl(impl, xyz1) == "cuda":
        return _argmin_cuda(xyz1, xyz2, None, valid2, both=False)
    return _argmin_plain(xyz1, xyz2, valid2)


@torch.library.register_fake(_nn_argmin_op)
def _(xyz1, xyz2, valid2, impl):
    return xyz1.new_empty(xyz1.shape[:2], dtype=torch.int32)


def nn_argmin_pair(xyz1, xyz2, valid1=None, valid2=None, *, impl: str = "auto"):
    """Both chamfer argmins, ``(idx1 (B,N), idx2 (B,M))`` int32: exactly
    ``(nn_argmin(xyz1, xyz2, valid2), nn_argmin(xyz2, xyz1, valid1))``, on
    the card in one launch that computes each pair's distance once. Not
    differentiable."""
    if xyz1.shape[1] == 0 or xyz2.shape[1] == 0:
        raise ValueError("nn_argmin_pair needs at least one point on each side")
    return _nn_argmin_pair_op(xyz1, xyz2, valid1, valid2, impl)


@gspn_op("nn_argmin_pair")
def _nn_argmin_pair_op(xyz1: torch.Tensor, xyz2: torch.Tensor, valid1: torch.Tensor | None,
                       valid2: torch.Tensor | None,
                       impl: str) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`nn_argmin_pair` as one opaque op."""
    if resolve_impl(impl, xyz1) == "cuda":
        return _argmin_cuda(xyz1, xyz2, valid1, valid2, both=True)
    return _argmin_plain(xyz1, xyz2, valid2), _argmin_plain(xyz2, xyz1, valid1)


@torch.library.register_fake(_nn_argmin_pair_op)
def _(xyz1, xyz2, valid1, valid2, impl):
    return (xyz1.new_empty(xyz1.shape[:2], dtype=torch.int32),
            xyz2.new_empty(xyz2.shape[:2], dtype=torch.int32))


def nn_distance(xyz1, xyz2, valid1=None, valid2=None, *, impl: str = "auto"):
    """Bidirectional nearest-neighbour squared distances ``(dist1 (B,N),
    idx1 (B,N) int32, dist2 (B,M), idx2 (B,M) int32)``. Distances are
    differentiable in both point sets, indices are not. Rows whose own
    point is padded still get values; mask them at the loss."""
    idx1, idx2 = nn_argmin_pair(xyz1.detach(), xyz2.detach(), valid1, valid2, impl=impl)
    d1 = xyz1 - gather_point(xyz2, idx1, impl=impl)
    d2 = xyz2 - gather_point(xyz1, idx2, impl=impl)
    dist1 = sqdist_components(d1[..., 0], d1[..., 1], d1[..., 2])
    dist2 = sqdist_components(d2[..., 0], d2[..., 1], d2[..., 2])
    return dist1, idx1, dist2, idx2


def chamfer_loss(pred, target, target_valid=None, *, impl: str = "auto"):
    """Symmetric chamfer loss: the mean over predicted points of ``dist1``
    plus the mean over valid target points of ``dist2``, averaged over the
    batch. Returns a scalar."""
    d1, _, d2, _ = nn_distance(pred, target, valid2=target_valid, impl=impl)
    l1 = d1.mean(dim=-1)
    if target_valid is not None:
        w = target_valid.to(d2.dtype)
        l2 = (d2 * w).sum(dim=-1) / torch.clamp(w.sum(dim=-1), min=1.0)
    else:
        l2 = d2.mean(dim=-1)
    return (l1 + l2).mean()
