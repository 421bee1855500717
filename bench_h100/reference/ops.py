"""Plain PyTorch point operations of the reference: the semantics the
program's kernels implement, written out with tensor operations only.

Distances are squared and taken from explicit differences, ``dx*dx +
dy*dy + dz*dz`` in that order; every selection breaks ties to the lowest
index. Each function records the work its call needs with
``workcount.point_op`` (a no-op unless a count is on), in the terms of
``workcount``'s module docstring.
"""

from __future__ import annotations

import torch

from bench_h100 import workcount as wc

_BIG = 1e10


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (..., N, 3), b (..., M, 3) -> (..., N, M)`` squared distances."""
    dx = a[..., :, None, 0] - b[..., None, :, 0]
    dy = a[..., :, None, 1] - b[..., None, :, 1]
    dz = a[..., :, None, 2] - b[..., None, :, 2]
    return dx * dx + dy * dy + dz * dz


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x (B, N, C)`` at ``idx (B, ...)`` -> ``(B, ..., C)``; when ``x``
    takes a gradient its backward is a gather's backward, counted as one
    add a gathered element."""
    b, c = x.shape[0], x.shape[-1]
    flat = idx.reshape(b, -1).long()
    out = torch.gather(x, 1, flat[..., None].expand(b, flat.shape[1], c))
    if x.requires_grad and torch.is_grad_enabled() and wc.counting_on():
        wc.point_op("index_add", wc.nbytes(out, idx) + x.numel() * x.element_size(), out.numel())
    return out.reshape(*idx.shape, c)


# ---------------------------------------------------------------- sampling


def morton_codes(xyz: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    """30-bit Morton codes of each scene's points normalized to its valid
    points' bounding box; invalid points get ``2**30`` (they sort last)."""

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    if valid is not None:
        v3 = valid[..., None]
        big = torch.full_like(xyz, 1e30)
        lo = torch.where(v3, xyz, big).amin(dim=1, keepdim=True)
        hi = torch.where(v3, xyz, -big).amax(dim=1, keepdim=True)
    else:
        lo = xyz.amin(dim=1, keepdim=True)
        hi = xyz.amax(dim=1, keepdim=True)
    scale = torch.full_like(lo, 1023.0) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((xyz - lo) * scale, 0, 1023).to(torch.int32)
    code = spread(q[..., 0]) | (spread(q[..., 1]) << 1) | (spread(q[..., 2]) << 2)
    if valid is not None:
        code = torch.where(valid, code, torch.full_like(code, 1 << 30))
    return code


def sorted_view(xyz, valid):
    """``(sxyz, svalid, sidx)``: the stable Morton sort of each scene."""
    order = torch.sort(morton_codes(xyz, valid), dim=1, stable=True).indices
    sxyz = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    svalid = None if valid is None else torch.gather(valid, 1, order)
    return sxyz, svalid, order


def fps_exact(xyz: torch.Tensor, npoint: int, valid: torch.Tensor | None) -> torch.Tensor:
    """Greedy farthest point sampling of every row: the first valid point,
    then the point farthest from those picked (invalid points never while
    a valid one remains). ``(B, N, 3) -> (B, npoint)`` int64."""
    b, n, _ = xyz.shape
    wc.point_op("fps", wc.nbytes(xyz, valid) + b * npoint * 4, b * (npoint - 1) * n * 10)
    rows = torch.arange(b, device=xyz.device)
    if valid is None:
        mind = torch.full((b, n), _BIG, device=xyz.device)
        prev = torch.zeros(b, dtype=torch.long, device=xyz.device)
    else:
        mind = torch.where(valid, torch.full((b, n), _BIG, device=xyz.device),
                           torch.full((b, n), -1.0, device=xyz.device))
        prev = valid.to(torch.uint8).argmax(dim=1)
    picks = [prev]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    for _ in range(1, npoint):
        c = xyz[rows, prev]
        dx, dy, dz = x - c[:, 0:1], y - c[:, 1:2], z - c[:, 2:3]
        mind = torch.minimum(mind, dx * dx + dy * dy + dz * dz)
        prev = mind.argmax(dim=1)
        picks.append(prev)
    return torch.stack(picks, dim=1)


def eligible_segments(segments: int, npoint: int, n: int) -> int:
    """The chain count a segmented FPS takes: the configured one where it
    divides both sizes and leaves each chain 8 picks or more, else 1."""
    if segments > 1 and npoint % segments == 0 and n % segments == 0 and npoint >= 8 * segments:
        return segments
    return 1


def fps(npoint: int, xyz, valid, segments: int = 1, mode: str = "contiguous"):
    """FPS with ``segments`` independent chains: contiguous slices of the
    row, or of its Morton-sorted view (``mode="spatial"``), their picks
    interleaved (column c: chain c % S's pick c // S); a chain with no
    valid point takes the scene's first valid point. int64 indices."""
    if segments == 1:
        return fps_exact(xyz, npoint, valid)
    if mode == "spatial":
        sxyz, svalid, sidx = sorted_view(xyz, valid)
        return torch.gather(sidx, 1, fps(npoint, sxyz, svalid, segments, "contiguous"))
    if mode != "contiguous":
        raise ValueError(f"fps mode {mode!r} is not in the reference")
    b, n, _ = xyz.shape
    m, ns = npoint // segments, n // segments
    xs = xyz.reshape(b * segments, ns, 3)
    vs = None if valid is None else valid.reshape(b * segments, ns)
    idx = fps_exact(xs, m, vs).reshape(b, segments, m)
    gidx = idx + (torch.arange(segments, device=xyz.device) * ns)[None, :, None]
    if valid is not None:
        has = vs.reshape(b, segments, ns).any(dim=2)
        first = valid.to(torch.uint8).argmax(dim=1)
        first = torch.where(valid.any(dim=1), first, torch.full_like(first, n - 1))
        gidx = torch.where(has[:, :, None], gidx, first[:, None, None])
    return gidx.transpose(1, 2).reshape(b, npoint)


# ---------------------------------------------------------------- grouping


def _first_k(hit: torch.Tensor, k: int):
    """``(idx (…, k), cnt (…))``: the first ``k`` hits of each row in index
    order, slots past the count repeating the first, rows without a hit
    all 0."""
    n = hit.shape[-1]
    iota = torch.arange(n, device=hit.device)
    pos = torch.where(hit, iota, torch.full_like(iota, n))
    first = torch.topk(pos, k, dim=-1, largest=False, sorted=True).values
    first = torch.where(first >= n, torch.zeros_like(first), first)
    cnt = torch.clamp(hit.sum(dim=-1), max=k)
    slot = torch.arange(k, device=hit.device)
    idx = torch.where(slot < cnt[..., None], first, first[..., :1])
    idx = torch.where(cnt[..., None] > 0, idx, torch.zeros_like(idx))
    return idx, cnt


def _tested(groups, n: int) -> int:
    """Points a first-K scan must test: up to each query's K-th hit in
    every scale, or all ``n``."""
    need = None
    for idx, cnt in groups:
        k = idx.shape[-1]
        p = torch.where(cnt == k, idx[..., -1] + 1, torch.full_like(cnt, n))
        need = p if need is None else torch.maximum(need, p)
    return int(need.sum().item())


def ball_group(radii, nsamples, xyz, queries, valid):
    """Multi-scale ball groups of ``queries (B, M, 3)`` over ``xyz (B, N,
    3)``: per scale ``(idx (B, M, K), cnt (B, M), local (B, M, K, 3))``, the
    first K points strictly inside the radius (``d2 < float32(r * r)``),
    ``local`` their coordinates less the query's."""
    d2 = sqdist(queries, xyz)
    out, groups = [], []
    for r, k in zip(radii, nsamples):
        hit = d2 < torch.tensor(float(r) * float(r), dtype=torch.float32, device=d2.device)
        if valid is not None:
            hit = hit & valid[:, None, :]
        idx, cnt = _first_k(hit, k)
        groups.append((idx, cnt))
        out.append((idx, cnt, gather_rows(xyz, idx) - queries[:, :, None, :]))
    if wc.counting_on():
        tested = _tested(groups, xyz.shape[1])
        outs = [t for o in out for t in o]
        wc.point_op("ball_group", wc.nbytes(xyz, valid, queries, *outs), tested * (8 + len(radii)))
    return out


def box_contains(boxes, xyz, valid=None):
    """``(B, R, N)``: the point lies in the box, bounds included."""
    p = xyz[:, None, :, :]
    inside = ((p >= boxes[..., None, 0:3]) & (p <= boxes[..., None, 3:6])).all(dim=-1)
    return inside if valid is None else inside & valid[:, None, :]


def box_group(boxes, s: int, xyz, valid):
    """The first ``s`` points inside each box: ``(idx, cnt, local)``, local
    about the box centre."""
    idx, cnt = _first_k(box_contains(boxes, xyz, valid), s)
    center = (boxes[..., 0:3] + boxes[..., 3:6]) * 0.5
    local = gather_rows(xyz, idx) - center[..., None, :]
    if wc.counting_on():
        wc.point_op("box_group", wc.nbytes(xyz, valid, boxes, idx, cnt, local),
                    _tested([(idx, cnt)], xyz.shape[1]) * 6)
    return idx, cnt, local


# ---------------------------------------------------------------- interpolation

_CHUNK_PAIRS = 1 << 26


def three_nn(targets, sources, valid=None):
    """The three nearest valid sources of every target, by (distance,
    index): ``(dist (B, N, 3), idx (B, N, 3))``."""
    b, n, _ = targets.shape
    m = sources.shape[1]
    wc.point_op("three_nn", wc.nbytes(targets, sources, valid) + b * n * 3 * 8, b * n * m * 9)
    step = max(1, _CHUNK_PAIRS // max(1, b * m))
    dists, idxs = [], []
    for lo in range(0, n, step):
        d2 = sqdist(targets[:, lo:lo + step], sources)
        if valid is not None:
            d2 = torch.where(valid[:, None, :], d2, torch.full_like(d2, _BIG))
        work = d2.clone()
        picks = []
        for _ in range(3):
            i = work.argmin(dim=-1, keepdim=True)
            picks.append(i)
            work.scatter_(-1, i, float("inf"))
        i3 = torch.cat(picks, dim=-1)
        dists.append(torch.gather(d2, -1, i3))
        idxs.append(i3)
    return torch.cat(dists, 1), torch.cat(idxs, 1)


def interp_weights(dist):
    """Inverse-distance weights ``(1/d) / sum(1/d)``, ``d >= 1e-10``."""
    d = torch.clamp(dist, min=1e-10)
    recip = torch.ones_like(d) / d
    return recip / (recip[..., 0:1] + recip[..., 1:2] + recip[..., 2:3])


def interpolate(points, idx, weight):
    """The weighted sum of ``points (B, M, C)`` over the three neighbours."""
    g = gather_rows(points, idx)  # (B, N, 3, C)
    w = weight[..., None]
    return g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1] + g[:, :, 2] * w[:, :, 2]


def fp_interpolate(points2, idx, dist, points1):
    """Feature propagation's input: the interpolated sources with the skip
    features after them (counted as one op with its weights)."""
    b, n, _ = idx.shape
    with _uncounted():
        out = interpolate(points2, idx, interp_weights(dist))
    if wc.counting_on():
        wc.point_op("interp", wc.nbytes(points2, idx, dist, points1) + b * n * 4 * (
            points2.shape[-1] + (0 if points1 is None else points1.shape[-1])),
            b * n * points2.shape[-1] * 5 + 11 * b * n)
        if points2.requires_grad and torch.is_grad_enabled():
            c = points2.shape[-1]
            wc.point_op("index_add", b * n * 3 * c * 4 + wc.nbytes(idx) + wc.nbytes(points2),
                        b * n * 3 * c)
    return out if points1 is None else torch.cat([out, points1], dim=-1)


class _uncounted:
    """Inside, the reference's calls record no work (a caller counts the
    whole op itself)."""

    def __enter__(self):
        self.token = wc._ACTIVE.set(None)

    def __exit__(self, *exc):
        wc._ACTIVE.reset(self.token)


# ---------------------------------------------------------------- masks, boxes

_CHUNK_TRIPLES = 1 << 25


def nearest_sample_logit(xyz, samples, logits):
    """Each scene point's nearest RoI sample's logit (the largest among
    samples at the same distance): ``xyz (B, N, 3)``, ``samples (B, R, S,
    3)``, ``logits (B, R, S)`` -> ``(B, R, N)``."""
    b, r, s, _ = samples.shape
    n = xyz.shape[1]
    wc.point_op("mask_project", wc.nbytes(xyz, samples, logits) + b * r * n * 4, b * r * s * n * 9)
    step = max(1, _CHUNK_TRIPLES // max(1, b * n * s))
    parts = []
    for lo in range(0, r, step):
        sm, lg = samples[:, lo:lo + step], logits[:, lo:lo + step]
        dx = xyz[:, None, :, None, 0] - sm[:, :, None, :, 0]
        dy = xyz[:, None, :, None, 1] - sm[:, :, None, :, 1]
        dz = xyz[:, None, :, None, 2] - sm[:, :, None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz
        near = d2 == d2.amin(dim=-1, keepdim=True)
        parts.append(torch.where(near, lg[:, :, None, :], torch.full_like(d2, -1e10)).amax(-1))
    return torch.cat(parts, dim=1)


def box_volume(boxes):
    ext = torch.clamp(boxes[..., 3:6] - boxes[..., 0:3], min=0.0)
    return ext[..., 0] * ext[..., 1] * ext[..., 2]


def box_iou(a, b):
    """``(..., Ra, 6), (..., Rb, 6) -> (..., Ra, Rb)``."""
    lo = torch.maximum(a[..., :, None, 0:3], b[..., None, :, 0:3])
    hi = torch.minimum(a[..., :, None, 3:6], b[..., None, :, 3:6])
    ext = torch.clamp(hi - lo, min=0.0)
    inter = ext[..., 0] * ext[..., 1] * ext[..., 2]
    union = box_volume(a)[..., :, None] + box_volume(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def nms(boxes, scores, iou_thresh: float):
    """Greedy NMS of every scene: boxes by descending score (ties in input
    order), each kept unless a kept box before it overlaps it above
    ``iou_thresh``. ``(B, R)`` bool in input order."""
    b, r, _ = boxes.shape
    wc.point_op("nms", wc.nbytes(boxes, scores) + b * r, b * r * r * 20)
    order = torch.sort(-scores, dim=-1, stable=True).indices
    bs = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 6))
    over = box_iou(bs, bs) > iou_thresh
    keep = torch.zeros((b, r), dtype=torch.bool, device=boxes.device)
    for i in range(r):
        hit = (keep[:, :i] & over[:, :i, i]).any(dim=-1)
        keep[:, i] = ~hit
    return torch.zeros_like(keep).scatter(1, order, keep)


def nn_pair(a, b, b_valid):
    """Both chamfer directions' nearest neighbours, ``a (R, N, 3)`` to the
    valid points of ``b (R, M, 3)`` and ``b`` to all of ``a``: ``(idx1,
    idx2)``."""
    rows, n, m = a.shape[0], a.shape[1], b.shape[1]
    wc.point_op("nn_argmin", wc.nbytes(a, b, b_valid) + rows * (n + m) * 4, rows * n * m * 10)
    d2 = sqdist(a, b)
    idx2 = d2.argmin(dim=1)
    d2 = torch.where(b_valid[:, None, :], d2, torch.full_like(d2, _BIG))
    return d2.argmin(dim=2), idx2
