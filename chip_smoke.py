#!/usr/bin/env python3
"""Drive the PyTorch port's inference slice once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero without them. Phases,
each announced by a ``phase <name> at <seconds> s`` line and printing one
line or a few:

1. device: the card's name and power limit, CUDA and nvcc versions;
2. build: compiles the hand-written kernels (``gspn_tpu_torch/csrc``), one
   ``nvcc`` per source, all at once;
3. kernels: each of the twelve kernels against its plain PyTorch version at
   the slice's shapes, bitwise (integer outputs equal, floats bit for
   bit), with the wrapper's and the plain version's times from CUDA events
   over as many launches, the kernel's own device time from
   ``torch.profiler``, the least time the card could take for the same
   work (``bound_ms``: the larger of the bytes over 3.35 TB/s and the
   operations over 33.5 T/s, counted from this run's inputs; see
   ``_bound``), and the time of one PyTorch call computing the same
   function where there is one (``library_ms``; never called by the port);
   strided selection must differ from first-K at SA1;
4. slices, seeded weights on the bench's scenes (``gspn_tpu_torch.utils.
   bench_slice``). Each runs its kernel path, with every launch count set to
   0 just before and read just after (the kernels it must launch grow, the
   others stay at 0), then a plain path: a model built from the plain
   config with the same weights (``bench_slice.plain_model``), which must
   launch no kernel. Masks, valid and classes equal; scores and boxes
   within rtol 1e-4 / atol 1e-5; masks neither empty nor full.
   (A) ``scannet_pipeline()`` as the JAX package ships it, thresholds moved
   for random weights (``bench_slice.slice_config``), at B=8 x N=8192 and
   the whole scene B=1 x N=65536: one warm-up and ``REQUESTS`` timed
   requests per path, and a small scene on the CPU as a second reference;
   (B) ``mask_project_prune="auto"`` at both shapes: every output equal to
   (A)'s, bit for bit;
   (C) ``roi_sample="grid"`` at B=8 x N=8192: three_nn over 8192 sources;
   (D) ``mask_project="3nn"`` at B=8 x N=8192;
   (E) ``group_select="strided"`` in both stages at both shapes: the
   strided ball and box groups in place of the first-K ones;
   (F) ``query_ball_point(_multi)`` at both shapes on (E)'s seeds and SA1
   centres from the shared FPS pass, launch counts set to 0 just before:
   strided crops and SA1, and first-K SA1, each equal to the matching ball
   group's indices and counts;
5. a JSON line of kernel results (``launches`` from the first slice that
   launches the kernel, named in ``slice``: (A) for the first-K path's,
   (B) for mask_project_boxed, (E) for the strided groups, (F) for the
   ball queries; ``launches_by_slice`` for each slice's own count;
   ``device_events``, the profiler's events under ``device_ms``), the
   card's name and power limit, and last ``{"ok": true, "device": {...}}``.

Any failure raises; no phase's error is caught. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

B, N = 8, 8192  # flagship request: 8 scenes x 8192 points
WS_N = 65536  # whole-scene request: 1 scene, last 10% of points padding
FLAGSHIP, WHOLE_SCENE = "B8xN8192", "B1xN65536"  # keys of bench_slice.SHAPES
REQUESTS = 20  # slice (A): timed requests per shape and path, after one warm-up
VARIANT_REQUESTS = 3  # slices (B)-(E)
KERNEL_ITERS = 20  # timed launches per kernel and per plain version
FIELDS = ("masks", "valid", "classes", "scores", "boxes")  # of InstancePredictions
PATH_KERNELS = {"fps", "ball_group", "box_group", "three_nn", "interp_mm", "nms"}
STRIDED = {"ball_group": "ball_group_strided", "box_group": "box_group_strided"}
# the kernel's symbols in the profiler's (demangled) device events; template
# arguments of group_scan_kernel: <box, strided, coordinates>
DEVICE_SYMBOLS = {
    "fps": ("fps_kernel",), "ball_group": ("group_scan_kernel<false, false, true>",),
    "ball_group_strided": ("group_scan_kernel<false, true, true>",),
    "box_group": ("group_scan_kernel<true, false, true>",),
    "box_group_strided": ("group_scan_kernel<true, true, true>",),
    "ball_query": ("group_scan_kernel<false, false, false>",),
    "ball_query_strided": ("group_scan_kernel<false, true, false>",),
    "three_nn": ("three_nn_kernel",), "interp_mm": ("interp_mm_kernel",),
    "mask_project": ("mask_project_kernel<false>",),
    "mask_project_boxed": ("mask_project_kernel<true>",), "nms": ("nms_kernel",),
}
SLICE_KERNELS = {  # what each slice's kernel path launches; the others stay at 0
    "A": PATH_KERNELS | {"mask_project"},
    "B": PATH_KERNELS | {"mask_project_boxed"},
    "C": PATH_KERNELS - {"box_group"} | {"mask_project"},
    "D": PATH_KERNELS,
    "E": {STRIDED.get(k, k) for k in PATH_KERNELS} | {"mask_project"},
    "F": {"fps", "ball_query", "ball_query_strided"},
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# H100 SXM float32 outside the tensor cores, one instruction per lane and
# clock: 132 SMs x 128 lanes x 1.98 GHz. The published 67 TFLOP/s counts an
# FMA as two; the kernels build with -fmad=false, so none of their adds,
# multiplies and compares is fused.
F32_OPS_PER_S = 33.5e12
_T0 = time.perf_counter()


def _phase(name: str) -> None:
    print(f"phase {name} at {time.perf_counter() - _T0:.1f} s", flush=True)


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """``(ms, "bytes" or "operations")``: the least time the card could
    take for work that moves ``nbytes`` (each input read once, each output
    written once) and does ``ops`` float32 operations (an add, multiply or
    compare each, at ``F32_OPS_PER_S``)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int, symbols: tuple[str, ...]) -> tuple[float, int]:
    """``(mean device ms per launch, events)`` of the kernel (any of
    ``symbols``) over ``iters`` calls of ``fn`` (one launch each) after a
    warm-up, from ``torch.profiler``'s device events: the kernel alone,
    without its wrapper's host work or other device work. The mean is over
    the ``events`` the profiler recorded, which may be fewer than
    ``iters``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    mine = [e for e in device if any(sym in e.name for sym in symbols)]
    if not mine:
        raise AssertionError(f"no device event of {symbols} among "
                             f"{sorted({e.name for e in device})}")
    return sum(e.time_range.end - e.time_range.start for e in mine) / 1e3 / len(mine), len(mine)


def _host_ms(fn) -> tuple[float, object]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _max_abs_err(got, want) -> float:
    """Max |got - want| over matching outputs; raises unless every pair is
    exactly equal (integers) or bitwise equal (floats)."""
    err = 0.0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        err = max(err, (g.double() - w.double()).abs().max().item() if g.numel() else 0.0)
        if not torch.equal(g, w):
            raise AssertionError(f"kernel differs from its plain version (max abs err {err})")
    return err


def _flatten(outs):
    if isinstance(outs, torch.Tensor):
        return [outs]
    return [t for o in outs for t in _flatten(o)]


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _first_k_tested(outs, n: int) -> int:
    """Points a first-K scan must test for these inputs: per query, up to
    its K-th hit in every scale (indices ascend), or all ``n``."""
    need = None
    for idx, cnt, *_ in outs:
        k = idx.shape[-1]
        p = torch.where(cnt == k, idx[..., -1].long() + 1,
                        torch.full_like(cnt, n, dtype=torch.long))
        need = p if need is None else torch.maximum(need, p)
    return int(need.sum().item())


def _chain_nms_case(dev, b: int, r: int, chain: int, gen):
    """Random boxes and scores, plus in every scene a chain of ``chain``
    boxes along x, each overlapping the next above IoU 0.25 (not the one
    after) with descending scores: greedy suppression alternates along it."""
    c = torch.rand((b, r, 3), generator=gen) * 4
    half = torch.rand((b, r, 3), generator=gen) * 0.6 + 0.1
    scores = torch.rand((b, r), generator=gen)
    c[:, :chain] = 10.0
    c[:, :chain, 0] += torch.arange(chain, dtype=torch.float32) * 0.35
    half[:, :chain] = 0.5
    scores[:, :chain] = 2.0 - torch.arange(chain, dtype=torch.float32) / r
    return torch.cat([c - half, c + half], dim=-1).to(dev), scores.to(dev)


def check_kernels(dev, ops, bench_slice):
    """Phase 3. Returns the JSON entries (time at each kernel's main shape)."""
    from gspn_tpu_torch.models.rpointnet import roi_grid_points
    from gspn_tpu_torch.ops.mask_project import (
        ROI_BLOCK_BOXED, TILE_N_BOXED, boxed_layout, tile_relevance,
    )

    xyz, valid = (torch.from_numpy(a).to(dev) for a in bench_slice.scenes(FLAGSHIP))
    ws, wsv = (torch.from_numpy(a).to(dev) for a in bench_slice.scenes(WHOLE_SCENE))
    gen = torch.Generator().manual_seed(0)

    def rois(pts, pvalid, sidx, sxyz, svalid):
        """The slice's shapes: 64 seeds from 8 spatial FPS chains, 1024 sa1
        centres, boxes about the seeds, their first 64 in-box points as RoI
        samples, and grid RoI points."""
        b = pts.shape[0]
        seeds = ops.gather_point(pts, torch.gather(sidx, 1, ops.farthest_point_sample(
            64, sxyz, svalid, segments=8, segment_mode="contiguous").long()))
        sa1 = ops.gather_point(pts, ops.farthest_point_sample(
            1024, pts, pvalid, segments=8, segment_mode="spatial"))
        half = (torch.rand((b, 64, 3), generator=gen) * 0.5 + 0.1).to(dev)
        boxes = torch.cat([seeds - half, seeds + half], dim=-1)
        roi_xyz = ops.query_box_group(boxes, 64, pts, pvalid)[2] + (
            (boxes[..., 0:3] + boxes[..., 3:6]) * 0.5)[..., None, :]
        logits = (torch.randn((b, 64, 64), generator=gen) * 0.1).to(dev)
        grid = roi_grid_points(boxes, 64)[0].reshape(b, 64 * 64, 3)
        return seeds, sa1, boxes, roi_xyz, logits, grid

    sxyz, svalid, sidx = ops.spatial_sorted_view(xyz, valid)
    wsx, wsvv, wsidx = ops.spatial_sorted_view(ws, wsv)
    seeds, sa1, boxes, roi_xyz, logits, grid = rois(xyz, valid, sidx, sxyz, svalid)
    ws_seeds, ws_sa1, ws_boxes, ws_roi_xyz, ws_logits, ws_grid = rois(ws, wsv, wsidx, wsx, wsvv)
    targets = xyz[:, None].expand(B, 64, N, 3).reshape(B * 64, N, 3)

    def fp(tgt, src, c):  # an FP level's interpolation inputs
        dist, idx = ops.three_nn(tgt, src)
        feats = torch.randn((src.shape[0], src.shape[1], c), generator=gen).to(dev)
        return feats, idx, ops.three_interpolate_weights(dist)

    fp4, fp1, ws_fp4 = fp(xyz, sa1, 128), fp(sa1[:, :64], sa1[:, 64:80], 512), fp(ws, ws_sa1, 128)
    tn, npad, rb, rpad = boxed_layout(N, 64, ROI_BLOCK_BOXED, TILE_N_BOXED)
    rel = tile_relevance(sxyz, svalid, boxes, tn, npad, rb, rpad)
    tn, npad, rb, rpad = boxed_layout(WS_N, 64, ROI_BLOCK_BOXED, TILE_N_BOXED)
    ws_rel = tile_relevance(wsx, wsvv, ws_boxes, tn, npad, rb, rpad)
    rel_share, ws_rel_share = rel.float().mean().item(), ws_rel.float().mean().item()
    print(f"mask_project_boxed: relevant (RoI block, tile) share {rel_share:.4f} "
          f"flagship, {ws_rel_share:.4f} whole scene")
    nms_scores = torch.rand((B, 64), generator=gen).to(dev)
    chain_boxes, chain_scores = _chain_nms_case(dev, B, 64, 32, gen)

    # work(plain outputs) -> (bytes, float32 operations) that these inputs
    # need; see _bound
    def fps_work(pts, pvalid, npoint):
        rows, n = pts.shape[:2]
        return lambda out: (_nbytes(pts, pvalid, out), rows * (npoint - 1) * n * 10)

    def ball_work(pts, pvalid, q, nscales, strided):
        # a point test: the squared distance (8) and a compare per scale;
        # first-K tests a prefix, strided every point once (the count pass
        # decides the selection; ranking re-reads what it already tested)
        n = pts.shape[1]

        def work(out):
            tested = q.shape[0] * q.shape[1] * n if strided else _first_k_tested(out, n)
            return _nbytes(pts, pvalid, q, *_flatten(out)), tested * (8 + nscales)
        return work

    def box_work(pts, pvalid, bx, strided):  # a point test: six compares
        n = pts.shape[1]

        def work(out):
            tested = bx.shape[0] * bx.shape[1] * n if strided else _first_k_tested([out], n)
            return _nbytes(pts, pvalid, bx, *out), tested * 6
        return work

    def nn_work(tgt, src, svld=None):  # a pair: the distance and a compare
        return lambda out: (_nbytes(tgt, src, svld, *out),
                            tgt.shape[0] * tgt.shape[1] * src.shape[1] * 9)

    def mm_work(args):  # a target channel: three multiplies, two adds
        pts, idx, _ = args
        return lambda out: (_nbytes(*args, out), idx.shape[0] * idx.shape[1] * pts.shape[2] * 5)

    def proj_work(pts, samp, lg, share=1.0, *extra):  # a (point, sample) pair
        b, r, s_, _ = samp.shape
        return lambda out: (_nbytes(pts, samp, lg, *extra, out),
                            b * r * s_ * pts.shape[1] * 9 * share)

    def nms_work(bx, sc):  # a pair: IoU (~19 operations) and the compare
        return lambda out: (_nbytes(bx, sc, out), bx.shape[0] * bx.shape[1] ** 2 * 20)

    def sparse_interp(args):
        """One ``torch.sparse.mm`` of a block-diagonal (B*N, B*M) weight
        matrix (three entries a row) with the (B*M, C) source rows: the
        same interpolation as one library call (the matrix is built here,
        untimed)."""
        pts, idx, w = args
        b, n, _ = idx.shape
        m, c = pts.shape[1:]
        rows = torch.arange(b * n, device=dev).repeat_interleave(3)
        cols = (idx.long() + (torch.arange(b, device=dev) * m)[:, None, None]).reshape(-1)
        mat = torch.sparse_coo_tensor(torch.stack([rows, cols]), w.reshape(-1),
                                      (b * n, b * m)).coalesce()
        dense = pts.reshape(b * m, c)
        return lambda: torch.sparse.mm(mat, dense).reshape(b, n, c)

    crops = ((0.25, 0.5, 1.0), (32, 64, 128))
    cases = {  # name -> [(shape label, fn(impl), work)], main shape first
        "fps": [
            (f"{B}x8 chains x {N // 8} pts, 128 picks",
             lambda impl: ops.farthest_point_sample(
                 128, sxyz.reshape(B * 8, N // 8, 3), svalid.reshape(B * 8, N // 8),
                 impl=impl),
             fps_work(sxyz.reshape(B * 8, N // 8, 3), svalid.reshape(B * 8, N // 8), 128)),
            (f"1x8 chains x {WS_N // 8} pts, 128 picks (whole scene)",
             lambda impl: ops.farthest_point_sample(
                 128, wsx.reshape(8, WS_N // 8, 3), wsvv.reshape(8, WS_N // 8),
                 impl=impl),
             fps_work(wsx.reshape(8, WS_N // 8, 3), wsvv.reshape(8, WS_N // 8), 128)),
        ],
        "ball_group": [
            (f"sa1: {B}x1024 queries, r 0.1, K 32",
             lambda impl: ops.query_ball_group_multi(
                 (0.1,), (32,), xyz, sa1, valid, impl=impl),
             ball_work(xyz, valid, sa1, 1, False)),
            (f"gspn crops: {B}x64 seeds, r .25/.5/1, K 32/64/128",
             lambda impl: ops.query_ball_group_multi(*crops, xyz, seeds, valid, impl=impl),
             ball_work(xyz, valid, seeds, 3, False)),
        ],
        "ball_group_strided": [
            (f"sa1: {B}x1024 queries, r 0.1, K 32",
             lambda impl: ops.query_ball_group_multi(
                 (0.1,), (32,), xyz, sa1, valid, impl=impl, select="strided"),
             ball_work(xyz, valid, sa1, 1, True)),
            (f"gspn crops: {B}x64 seeds, r .25/.5/1, K 32/64/128",
             lambda impl: ops.query_ball_group_multi(
                 *crops, xyz, seeds, valid, impl=impl, select="strided"),
             ball_work(xyz, valid, seeds, 3, True)),
            (f"sa1, whole scene: 1x1024 queries x {WS_N} pts, r 0.1, K 32",
             lambda impl: ops.query_ball_group_multi(
                 (0.1,), (32,), ws, ws_sa1, wsv, impl=impl, select="strided"),
             ball_work(ws, wsv, ws_sa1, 1, True)),
            (f"gspn crops, whole scene: 1x64 seeds x {WS_N} pts",
             lambda impl: ops.query_ball_group_multi(
                 *crops, ws, ws_seeds, wsv, impl=impl, select="strided"),
             ball_work(ws, wsv, ws_seeds, 3, True)),
        ],
        "box_group": [
            (f"{B}x64 RoIs, S 64",
             lambda impl: ops.query_box_group(boxes, 64, xyz, valid, impl=impl),
             box_work(xyz, valid, boxes, False)),
        ],
        "box_group_strided": [
            (f"{B}x64 RoIs, S 64",
             lambda impl: ops.query_box_group(boxes, 64, xyz, valid, impl=impl,
                                              select="strided"),
             box_work(xyz, valid, boxes, True)),
            (f"whole scene: 1x64 RoIs x {WS_N} pts, S 64",
             lambda impl: ops.query_box_group(ws_boxes, 64, ws, wsv, impl=impl,
                                              select="strided"),
             box_work(ws, wsv, ws_boxes, True)),
        ],
        "ball_query": [
            (f"sa1: {B}x1024 queries, r 0.1, K 32",
             lambda impl: ops.query_ball_point(0.1, 32, xyz, sa1, valid, impl=impl),
             lambda out: ball_work(xyz, valid, sa1, 1, False)([out])),
            (f"gspn crops: {B}x64 seeds, r .25/.5/1, K 32/64/128",
             lambda impl: ops.query_ball_point_multi(*crops, xyz, seeds, valid, impl=impl),
             ball_work(xyz, valid, seeds, 3, False)),
        ],
        "ball_query_strided": [
            (f"sa1: {B}x1024 queries, r 0.1, K 32",
             lambda impl: ops.query_ball_point(0.1, 32, xyz, sa1, valid, impl=impl,
                                               select="strided"),
             lambda out: ball_work(xyz, valid, sa1, 1, True)([out])),
            (f"gspn crops: {B}x64 seeds, r .25/.5/1, K 32/64/128",
             lambda impl: ops.query_ball_point_multi(
                 *crops, xyz, seeds, valid, impl=impl, select="strided"),
             ball_work(xyz, valid, seeds, 3, True)),
            (f"gspn crops, whole scene: 1x64 seeds x {WS_N} pts",
             lambda impl: ops.query_ball_point_multi(
                 *crops, ws, ws_seeds, wsv, impl=impl, select="strided"),
             ball_work(ws, wsv, ws_seeds, 3, True)),
        ],
        "three_nn": [
            (f"fp4: {B}x{N} targets <- 1024",
             lambda impl: ops.three_nn(xyz, sa1, impl=impl), nn_work(xyz, sa1)),
            (f"3nn masks: {B * 64}x{N} targets <- 64",
             lambda impl: ops.three_nn(targets, roi_xyz.reshape(B * 64, 64, 3), impl=impl),
             nn_work(targets, roi_xyz.reshape(B * 64, 64, 3))),
            (f"grid RoIAlign: {B}x4096 targets <- {N}",
             lambda impl: ops.three_nn(grid, xyz, valid, impl=impl), nn_work(grid, xyz, valid)),
            (f"grid RoIAlign, whole scene: 1x4096 targets <- {WS_N}",
             lambda impl: ops.three_nn(ws_grid, ws, wsv, impl=impl),
             nn_work(ws_grid, ws, wsv)),
        ],
        "interp_mm": [
            (f"fp4: {B}x{N} <- 1024, C 128",
             lambda impl: ops.three_interpolate_mm(*fp4, impl=impl), mm_work(fp4)),
            (f"fp1: {B}x64 <- 16, C 512",
             lambda impl: ops.three_interpolate_mm(*fp1, impl=impl), mm_work(fp1)),
            (f"fp4, whole scene: 1x{WS_N} <- 1024, C 128",
             lambda impl: ops.three_interpolate_mm(*ws_fp4, impl=impl), mm_work(ws_fp4)),
        ],
        "mask_project": [
            (f"{B}x64 RoIs x {N} pts, S 64",
             lambda impl: ops.nearest_sample_logit(xyz, roi_xyz, logits, impl=impl),
             proj_work(xyz, roi_xyz, logits)),
            (f"1x64 RoIs x {WS_N} pts, S 64 (whole scene)",
             lambda impl: ops.nearest_sample_logit(ws, ws_roi_xyz, ws_logits, impl=impl),
             proj_work(ws, ws_roi_xyz, ws_logits)),
        ],
        "mask_project_boxed": [
            (f"Morton-sorted {B}x64 RoIs x {N} pts, S 64",
             lambda impl: ops.nearest_sample_logit_boxed(
                 sxyz, roi_xyz, logits, boxes, point_valid=svalid, impl=impl),
             proj_work(sxyz, roi_xyz, logits, rel_share, boxes, svalid)),
            (f"Morton-sorted 1x64 RoIs x {WS_N} pts, S 64 (whole scene)",
             lambda impl: ops.nearest_sample_logit_boxed(
                 wsx, ws_roi_xyz, ws_logits, ws_boxes, point_valid=wsvv, impl=impl),
             proj_work(wsx, ws_roi_xyz, ws_logits, ws_rel_share, ws_boxes, wsvv)),
        ],
        "nms": [
            (f"{B}x64 RoI boxes, random scores, IoU 0.25",
             lambda impl: ops.nms_3d_batched(boxes, nms_scores, 0.25, impl=impl),
             nms_work(boxes, nms_scores)),
            (f"{B}x64 boxes with a suppression chain 32 deep",
             lambda impl: ops.nms_3d_batched(chain_boxes, chain_scores, 0.25, impl=impl),
             nms_work(chain_boxes, chain_scores)),
        ],
    }
    library = {"interp_mm": sparse_interp(fp4)}  # name -> one PyTorch call at the main shape
    entries = []
    for name, shapes in cases.items():
        k = ops.KERNELS[name]
        main = None
        for label, fn, work in shapes:
            want = fn("plain")
            err = _max_abs_err(_flatten(fn("cuda")), _flatten(want))
            ms = _cuda_ms(lambda fn=fn: fn("cuda"), KERNEL_ITERS)
            plain_ms = _cuda_ms(lambda fn=fn: fn("plain"), KERNEL_ITERS)
            dev_ms, events = _device_ms(lambda fn=fn: fn("cuda"), KERNEL_ITERS,
                                        DEVICE_SYMBOLS[name])
            bound_ms, bound_by = _bound(*work(want))
            print(f"kernel {name} [{label}]: equal to plain (max abs err {err}); "
                  f"wrapper {ms:.4f} ms (kernel's device time {dev_ms:.4f} ms over "
                  f"{events} of {KERNEL_ITERS} launches), "
                  f"plain {plain_ms:.4f} ms; bound {bound_ms:.5f} ms ({bound_by})")
            if main is None:
                main = (err, ms, plain_ms, dev_ms, events, bound_ms, bound_by)
        library_ms = None
        if name in library:
            lib_err = (library[name]() - cases[name][0][1]("cuda")).abs().max().item()
            if lib_err > 1e-4:
                raise AssertionError(f"{name}: the library call differs by {lib_err}")
            library_ms = _cuda_ms(library[name], KERNEL_ITERS)
            print(f"kernel {name} [{shapes[0][0]}]: library call {library_ms:.4f} ms "
                  f"(max abs diff {lib_err:.2e})")
        entries.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": "; ".join(r.split()[0] for r in k.replaces.split("; ")),
            "launches": 0, "max_abs_err": main[0], "ms": main[1], "plain_ms": main[2],
            "device_ms": main[3], "device_events": main[4], "bound_ms": main[5],
            "bound_by": main[6],
            "library_ms": library_ms,
        })

    first = ops.query_ball_group_multi((0.1,), (32,), xyz, sa1, valid)[0][0]
    strided = ops.query_ball_group_multi((0.1,), (32,), xyz, sa1, valid, select="strided")[0][0]
    rows = (first != strided).any(dim=-1).sum().item()
    if not rows:
        raise AssertionError("sa1: strided selection equals first-K")
    print(f"sa1: strided selection differs from first-K in {rows} of {B * 1024} balls")
    return entries


def _timed_requests(infer, model, req, n_requests):
    """One warm-up request, then ``n_requests`` timed ones on the host clock
    around a synchronized call. Returns ``(ms per request, output)`` and
    raises unless every timed request gave the same output."""
    xyz, valid, eps = req
    infer(model, xyz, valid, z_eps=eps)
    times, first = [], None
    for _ in range(n_requests):
        ms, out = _host_ms(lambda: infer(model, xyz, valid, z_eps=eps))
        times.append(ms)
        if first is None:
            first = out
            continue
        for f in FIELDS:
            if not torch.equal(getattr(out, f), getattr(first, f)):
                raise AssertionError(f"repeated requests differ in {f}")
    return times, first


def _spread(times) -> str:
    return (f"median {statistics.median(times):.3f} ms/batch (min {min(times):.3f}, "
            f"max {max(times):.3f}; {len(times)} requests after a warm-up)")


def run_slice(name, ops, bench_slice, cfg, model, reqs, n_requests):
    """One slice: the kernel path on ``reqs`` with the launch counts set to 0
    just before and read just after, then the plain path, which must launch
    nothing, and the comparison. Returns ``(kernel {shape: (times, out)},
    plain {shape: (times, out)}, counts)``."""
    from gspn_tpu_torch.models.pipeline import make_inference_fn

    _phase(f"slice ({name})")
    pcfg, pmodel = bench_slice.plain_model(cfg, model)
    infer, infer_plain = make_inference_fn(cfg), make_inference_fn(pcfg)
    ops.reset_launch_counts()
    kernel = {shape: _timed_requests(infer, model, req, n_requests) for shape, req in reqs.items()}
    counts = ops.launch_counts()
    print(f"slice ({name}) launches: {json.dumps(counts)}")
    launched = {k for k, c in counts.items() if c}
    if launched != SLICE_KERNELS[name]:
        raise AssertionError(f"slice ({name}) launched {sorted(launched)}, "
                             f"expected {sorted(SLICE_KERNELS[name])}")

    plain = {shape: _timed_requests(infer_plain, pmodel, req, n_requests)
             for shape, req in reqs.items()}
    if ops.launch_counts() != counts:
        raise AssertionError(f"slice ({name}): the plain path launched kernels")
    for shape, (_, got) in kernel.items():
        want = plain[shape][1]
        b, n_pts = reqs[shape][1].shape
        if tuple(got.masks.shape) != (b, cfg.num_seeds, n_pts):
            raise AssertionError(f"({name}) {shape}: masks shape {tuple(got.masks.shape)}")
        for f in ("scores", "boxes"):
            if not torch.isfinite(getattr(got, f)).all():
                raise AssertionError(f"({name}) {shape}: non-finite {f}")
        for f in ("masks", "valid", "classes"):
            if not torch.equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"({name}) {shape}: kernel path and plain path differ in {f}")
        for f in ("scores", "boxes"):
            torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=1e-4, atol=1e-5)
        m = got.masks[got.valid]
        share = m.float().mean().item() if m.numel() else 0.0
        if not 0.0 < share < 1.0:
            raise AssertionError(f"({name}) {shape}: masks of valid instances hold {share} "
                                 "of the points")
        print(f"slice ({name}) {shape}: kernel path == plain path (masks, valid, classes equal; "
              f"scores, boxes within rtol 1e-4 atol 1e-5); {int(got.valid.sum())} valid "
              f"instances, mask share {share:.4f}; kernel {_spread(kernel[shape][0])}; "
              f"plain {_spread(plain[shape][0])}")
    return kernel, plain, counts


def run_entry_points(ops, cfg, reqs):
    """Slice (F): ``query_ball_point(_multi)`` on (E)'s seeds and SA1
    centres from the shared FPS pass, with the launch counts set to 0 just
    before and read just after: strided crops and SA1 as (E)'s stages group
    them, and first-K SA1. Afterwards each result is held against the
    matching ball group's indices and counts. Returns the launch counts."""
    from gspn_tpu_torch.models.pipeline import shared_fps_indices_view

    _phase("slice (F)")
    g, sa = cfg.gspn, cfg.rpointnet.sa_layers[0]
    ops.reset_launch_counts()
    runs = {}
    for shape, (xyz, valid, _) in reqs.items():
        seed_idx, sa1_idx, _ = shared_fps_indices_view(cfg, xyz, valid)
        seeds, centres = ops.gather_point(xyz, seed_idx), ops.gather_point(xyz, sa1_idx)
        crops = ops.query_ball_point_multi(g.context_radii, g.context_nsample, xyz, seeds, valid,
                                           select="strided")
        sa1 = ops.query_ball_point(sa.radius, sa.nsample, xyz, centres, valid, select="strided")
        sa1_first = ops.query_ball_point(sa.radius, sa.nsample, xyz, centres, valid)
        runs[shape] = (xyz, valid, seeds, centres, crops + [sa1, sa1_first])
    counts = ops.launch_counts()
    print(f"slice (F) launches: {json.dumps(counts)}")
    launched = {k for k, c in counts.items() if c}
    if launched != SLICE_KERNELS["F"]:
        raise AssertionError(f"slice (F) launched {sorted(launched)}, "
                             f"expected {sorted(SLICE_KERNELS['F'])}")
    sa1_scale = ((sa.radius,), (sa.nsample,))
    for shape, (xyz, valid, seeds, centres, queried) in runs.items():
        grouped = ops.query_ball_group_multi(g.context_radii, g.context_nsample, xyz, seeds,
                                             valid, select="strided")
        grouped += ops.query_ball_group_multi(*sa1_scale, xyz, centres, valid, select="strided")
        grouped += ops.query_ball_group_multi(*sa1_scale, xyz, centres, valid)
        for got, want in zip(queried, grouped, strict=True):
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"(F) {shape}: ball query differs from the ball group")
        print(f"slice (F) {shape}: ball queries == ball groups' indices and counts "
              f"(strided crops and SA1, first-K SA1)")
    return counts


def run_slices(dev, ops, bench_slice, card):
    """Phase 4. Returns ``{slice: launch counts of its kernel path}``."""
    from gspn_tpu_torch.data import synthetic
    from gspn_tpu_torch.models.pipeline import make_inference_fn

    cfg = bench_slice.slice_config()
    model = bench_slice.seeded_model(cfg, dev)
    reqs = {shape: bench_slice.request(cfg, shape, dev, seed)
            for seed, shape in enumerate((FLAGSHIP, WHOLE_SCENE), start=1)}
    flagship = {FLAGSHIP: reqs[FLAGSHIP]}
    with torch.inference_mode():
        kernel, plain, counts = run_slice("A", ops, bench_slice, cfg, model, reqs, REQUESTS)
        per_request = {k: c / (2 * (REQUESTS + 1)) for k, c in counts.items()}
        runs = {"A": counts}

        pcfg = bench_slice.variant_config("prune")
        pruned, _, runs["B"] = run_slice("B", ops, bench_slice, pcfg, model, reqs, VARIANT_REQUESTS)
        for shape, (_, out) in pruned.items():
            for f in FIELDS:
                if not torch.equal(getattr(out, f), getattr(kernel[shape][1], f)):
                    raise AssertionError(f"(B) {shape}: pruned projection differs from (A) in {f}")
        print("slice (B): every output equal to (A)'s at both shapes")

        gcfg = bench_slice.variant_config("grid")
        _, _, runs["C"] = run_slice("C", ops, bench_slice, gcfg,
                                    bench_slice.rebuilt_model(gcfg, model), flagship,
                                    VARIANT_REQUESTS)
        grid_nn = runs["C"]["three_nn"] / (VARIANT_REQUESTS + 1) - per_request["three_nn"]
        if grid_nn != 1:
            raise AssertionError(f"(C): {grid_nn} three_nn launches per request beside the FP's")
        print(f"slice (C): one three_nn launch per request over {N} sources (grid RoIAlign)")

        _, _, runs["D"] = run_slice("D", ops, bench_slice, bench_slice.variant_config("3nn"),
                                    model, flagship, VARIANT_REQUESTS)

        scfg = bench_slice.variant_config("strided")
        smodel = bench_slice.rebuilt_model(scfg, model)
        strided, _, runs["E"] = run_slice("E", ops, bench_slice, scfg, smodel, reqs,
                                          VARIANT_REQUESTS)
        for shape, (_, out) in strided.items():
            moved = (out.masks != kernel[shape][1].masks).float().mean().item()
            print(f"slice (E) {shape}: mask entries that differ from (A)'s: {moved:.6f}")
        runs["F"] = run_entry_points(ops, scfg, reqs)

        # a second reference: the CPU's plain path (the one the CPU tests hold
        # against JAX) on a small scene; the MLPs' matmul sums differ between
        # CPU and GPU, so masks may flip at a logit's threshold: allow 1e-3
        # of them
        _phase("cpu reference")
        infer = make_inference_fn(cfg)
        sb = synthetic.scene_batch(np.random.default_rng(0), 1, n_points=2048,
                                   max_instances=4, extent=2.0)
        sx, sv = torch.from_numpy(sb["xyz"]), torch.from_numpy(sb["valid"])
        seps = torch.randn((1, cfg.num_seeds, cfg.gspn.latent_dim),
                           generator=torch.Generator().manual_seed(3))
        gpu = infer(model, sx.to(dev), sv.to(dev), z_eps=seps.to(dev))
        cpu = infer(bench_slice.seeded_model(cfg, torch.device("cpu")), sx, sv, z_eps=seps)
        flips = (gpu.masks.cpu() != cpu.masks).float().mean().item()
        if flips > 1e-3 or not torch.equal(gpu.valid.cpu(), cpu.valid):
            raise AssertionError(f"GPU vs CPU on a small scene: mask flips {flips}, "
                                 f"valid equal {torch.equal(gpu.valid.cpu(), cpu.valid)}")
        torch.testing.assert_close(gpu.boxes.cpu(), cpu.boxes, rtol=1e-4, atol=1e-4)
        print(f"slice (A) B=1 x N=2048: GPU kernel path vs CPU plain path: valid equal, "
              f"mask flips {flips}, boxes within 1e-4")

    for shape, (times, _) in kernel.items():
        points = reqs[shape][0].shape[0] * reqs[shape][0].shape[1]
        print(f"slice (A) {shape} kernel path: {_spread(times)}, "
              f"{points / statistics.median(times) * 1e3:.0f} points/s; "
              f"plain path {_spread(plain[shape][0])} [{card}]")
        print(f"slice (A) {shape} kernel path requests ms: {[round(x, 3) for x in times]}")
    return runs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    card = _card()
    from gspn_tpu_torch import ops
    from gspn_tpu_torch.ops import _cuda
    from gspn_tpu_torch.utils import bench_slice

    _phase("device")
    nvcc = subprocess.run([_cuda.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{nvcc.splitlines()[-1]}")
    bench_slice.float32_matmuls()

    _phase("build")
    lib, secs = _cuda.build()
    _cuda.library()
    print(f"build: {lib.name} in {secs:.1f} s")

    dev = torch.device("cuda", 0)
    _phase("kernels")
    entries = check_kernels(dev, ops, bench_slice)
    runs = run_slices(dev, ops, bench_slice, card)
    for e in entries:
        e["slice"] = next(s for s, c in runs.items() if c[e["name"]])
        e["launches"] = runs[e["slice"]][e["name"]]
        e["launches_by_slice"] = {s: c[e["name"]] for s, c in runs.items()}
    _phase("report")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
