"""RoI-mask projection: the nearest sample's logit for every scene point.

Counterpart of ``gspn_tpu/ops/mask_project.py``. For scene point p and RoI
r the output is the mask logit of r's sample nearest to p; invalid samples
sit at distance 3e10 and never give their logit; on a tie the largest logit
among the tied valid samples wins; a RoI with no valid sample gives -1e10.
Distances are ``sqdist_components`` of ``p - sample``. Box membership and
the threshold stay with the caller (``models/pipeline.py``).

CUDA route ``csrc/mask_project.cu``: the dense kernel and the box-pruned
one, which writes the -1e10 fill wherever :func:`tile_relevance` says no
box of a RoI block touches a scene tile. Logits are assumed above -1e10.
"""

from __future__ import annotations

import torch

from gspn_tpu_torch.ops import _cuda
from gspn_tpu_torch.ops.common import gspn_op, resolve_impl, round_up, sqdist_components

KERNEL = _cuda.KERNELS["mask_project"]
BOXED_KERNEL = _cuda.KERNELS["mask_project_boxed"]

NEG = -1e10  # the fill: no valid sample, or a pruned tile
INVALID_D2 = 3e10  # the distance an invalid sample sits at
ROI_BLOCK_BOXED = 8  # RoIs per relevance row (the JAX package's _ROI_BLOCK_BOXED)
TILE_N_BOXED = 2048  # scene points per relevance column (_TN_BOXED)

# (RoI, point, sample) triples one plain chunk holds: 128 MB of float32
_PLAIN_TRIPLES = 1 << 25


def _nearest_logit_dense(xyz, sampled, logits, svalid):
    d = [xyz[:, None, :, None, k] - sampled[:, :, None, :, k] for k in range(3)]
    d2 = sqdist_components(*d)  # (B, R, N, S)
    sv = svalid[:, :, None, :]
    d2 = torch.where(sv, d2, torch.full_like(d2, INVALID_D2))
    dmin = d2.amin(dim=-1, keepdim=True)
    cand = torch.where((d2 == dmin) & sv, logits[:, :, None, :], torch.full_like(d2, NEG))
    return cand.amax(dim=-1)


def _nearest_logit_plain(xyz, sampled, logits, svalid):
    """The dense (B, R, N, S) form over chunks of RoIs: a whole scene's
    tensor would be ~1 GB per float tensor."""
    b, r, s, _ = sampled.shape
    step = max(1, _PLAIN_TRIPLES // max(1, b * xyz.shape[1] * s))
    if r <= step:
        return _nearest_logit_dense(xyz, sampled, logits, svalid)
    return torch.cat(
        [
            _nearest_logit_dense(xyz, sampled[:, i:i + step], logits[:, i:i + step],
                                 svalid[:, i:i + step])
            for i in range(0, r, step)
        ],
        dim=1,
    )


def _launch(kernel, xyz, sampled, logits, svalid, rel=None, rb=1, tn=1):
    b, n, _ = xyz.shape
    r, s = logits.shape[1:]
    dev = xyz.device
    xyz = xyz.contiguous()
    sampled = sampled.contiguous()
    logits = logits.contiguous()
    v = _cuda.flag_bytes(svalid)
    _cuda.check_cuda_input("xyz", xyz, torch.float32, (b, n, 3))
    _cuda.check_cuda_input("sampled", sampled, torch.float32, (b, r, s, 3))
    _cuda.check_cuda_input("logits", logits, torch.float32, (b, r, s))
    _cuda.check_cuda_input("sample_valid", v, torch.uint8, (b, r, s))
    if rel is not None:
        _cuda.check_cuda_input("relevance", rel, torch.int32, rel.shape)
    out = torch.empty((b, r, n), dtype=torch.float32, device=dev)
    if b and r and n:
        args = [_cuda.ptr(xyz), _cuda.ptr(sampled), _cuda.ptr(logits), _cuda.ptr(v), b, n, r, s]
        if rel is not None:
            args += [_cuda.ptr(rel), rb, tn, rel.shape[1], rel.shape[2]]
        kernel.launch(dev, *args, _cuda.ptr(out))
    return out


def nearest_sample_logit(xyz, sampled, logits, sample_valid=None, *, impl: str = "auto"):
    """``xyz (B,N,3)``, ``sampled (B,R,S,3)``, ``logits (B,R,S)``,
    ``sample_valid (B,R,S)`` -> ``(B,R,N)`` float32: each scene point's
    nearest-sample logit."""
    if sample_valid is None:
        sample_valid = torch.ones(logits.shape, dtype=torch.bool, device=logits.device)
    return _nearest_logit_op(xyz, sampled, logits, sample_valid, impl)


@gspn_op("nearest_sample_logit")
def _nearest_logit_op(xyz: torch.Tensor, sampled: torch.Tensor, logits: torch.Tensor,
                      sample_valid: torch.Tensor, impl: str) -> torch.Tensor:
    """:func:`nearest_sample_logit` as one opaque op."""
    if resolve_impl(impl, xyz) == "cuda":
        return _launch(KERNEL, xyz, sampled, logits, sample_valid)
    return _nearest_logit_plain(xyz, sampled, logits, sample_valid)


@torch.library.register_fake(_nearest_logit_op)
def _(xyz, sampled, logits, sample_valid, impl):
    return xyz.new_empty((xyz.shape[0], logits.shape[1], xyz.shape[1]))


def boxed_layout(n: int, r: int, roi_block: int, tile_n: int) -> tuple[int, int, int, int]:
    """``(tn, npad, rb, rpad)``: the TPU kernel's tiling
    (``_pack_operands``), which the relevance table is laid out in."""
    npad = round_up(n, 128)
    tn = min(tile_n, npad)
    npad = round_up(npad, tn)
    rb = min(roi_block, round_up(r, 8))
    return tn, npad, rb, round_up(r, rb)


def tile_relevance(xyz, point_valid, boxes, tn: int, npad: int, rb: int, rpad: int):
    """``(B, rpad/rb, npad/tn)`` int32: 1 where some box of RoI block j
    meets the bounding box of scene tile k's valid points (inclusive); a
    tile with no valid point meets nothing. ``_tile_relevance`` of the JAX
    package."""
    b, n, _ = xyz.shape
    r = boxes.shape[1]
    nt = npad // tn
    pts = torch.zeros((b, npad, 3), dtype=torch.float32, device=xyz.device)
    pts[:, :n] = xyz
    vm = torch.zeros((b, npad), dtype=torch.bool, device=xyz.device)
    vm[:, :n] = point_valid
    pts = pts.reshape(b, nt, tn, 3)
    vm = vm.reshape(b, nt, tn, 1)
    tmin = torch.where(vm, pts, torch.full_like(pts, torch.inf)).amin(dim=2)  # (B, nt, 3)
    tmax = torch.where(vm, pts, torch.full_like(pts, -torch.inf)).amax(dim=2)
    inter = (
        (boxes[:, :, None, 0:3] <= tmax[:, None]) & (boxes[:, :, None, 3:6] >= tmin[:, None])
    ).all(dim=-1)  # (B, R, nt)
    padded = torch.zeros((b, rpad, nt), dtype=torch.bool, device=xyz.device)
    padded[:, :r] = inter
    return padded.reshape(b, rpad // rb, rb, nt).any(dim=2).to(torch.int32)


def nearest_sample_logit_boxed(
    xyz, sampled, logits, boxes, sample_valid=None, point_valid=None, *,
    impl: str = "auto", roi_block: int | None = None, tile_n: int | None = None,
):
    """Box-pruned :func:`nearest_sample_logit`, ``(B,R,N)`` float32: the
    dense result where :func:`tile_relevance` is 1 for (r's RoI block,
    p's scene tile), and the -1e10 fill elsewhere. Every valid point
    inside r's box gets the dense logit. Pruning needs spatially compact
    tiles, i.e. ``xyz`` in a Morton-sorted order (``ops.spatial_sorted_view``)."""
    b, n, _ = xyz.shape
    r = logits.shape[1]
    if sample_valid is None:
        sample_valid = torch.ones(logits.shape, dtype=torch.bool, device=logits.device)
    if point_valid is None:
        point_valid = torch.ones((b, n), dtype=torch.bool, device=xyz.device)
    tn, npad, rb, rpad = boxed_layout(n, r, roi_block or ROI_BLOCK_BOXED, tile_n or TILE_N_BOXED)
    rel = tile_relevance(xyz, point_valid, boxes, tn, npad, rb, rpad)
    return _nearest_logit_boxed_op(xyz, sampled, logits, sample_valid, rel, rb, tn, impl)


@gspn_op("nearest_sample_logit_boxed")
def _nearest_logit_boxed_op(xyz: torch.Tensor, sampled: torch.Tensor, logits: torch.Tensor,
                            sample_valid: torch.Tensor, rel: torch.Tensor, rb: int, tn: int,
                            impl: str) -> torch.Tensor:
    """:func:`nearest_sample_logit_boxed` from its relevance table ``rel``
    (RoI blocks of ``rb``, scene tiles of ``tn``) as one opaque op."""
    if resolve_impl(impl, xyz) == "cuda":
        return _launch(BOXED_KERNEL, xyz, sampled, logits, sample_valid, rel.contiguous(), rb, tn)
    r, n = logits.shape[1], xyz.shape[1]
    dense = _nearest_logit_plain(xyz, sampled, logits, sample_valid)
    keep = rel.repeat_interleave(rb, dim=1).repeat_interleave(tn, dim=2)[:, :r, :n]
    return torch.where(keep.bool(), dense, torch.full_like(dense, NEG))


@torch.library.register_fake(_nearest_logit_boxed_op)
def _(xyz, sampled, logits, sample_valid, rel, rb, tn, impl):
    return xyz.new_empty((xyz.shape[0], logits.shape[1], xyz.shape[1]))
