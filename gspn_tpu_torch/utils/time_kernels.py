"""Timing of the hand-written kernels on the card, and every launch of the
ranked slices' kernels: a flagship and a whole-scene request, a pass of
the ball-query entry points, a stage-1 and a stage-2 training step.

    python gspn_tpu_torch/utils/time_kernels.py [--tree DIR] [--kernels a,b]

``chip_smoke.py``'s kernel phase times every kernel with ``cuda_ms`` and
``device_ms``, holds it against its plain version with ``max_abs_err``,
and takes the ranked slices' shapes from ``cases``: every kernel launch
of one flagship and one whole-scene request of slices (A) (the main
path: fps, ball_group, box_group, nms, three_nn, interp_mm and
mask_project), (B) (mask_project_boxed on the sorted view in place of
mask_project), (E) (strided selection: ball_group_strided and
box_group_strided in place of the first-K groups) and (H) (the exact FPS:
fps over whole rows, fps_cluster at the whole scene), of one pass of (F)
at each shape (the shared FPS pass, then ball_query_strided at SA1 and the
crops and ball_query at SA1), and of one training step of (G) (the seeds'
fps, the crops' ball_group, nn_argmin both ways in one launch and
index_add, the chamfer's gather backward), and of one stage-2 training
step of (I) (``stage2_launches``: fps's shared pass and SA2-SA4, the
frozen GSPN's crops and SA1-SA4's ball_group, the RoIAlign box_group,
three_nn and interp_mm at FP1-FP4, and the backward's eight index_add
launches), each at its own shape; also index_add with 512 positions on
each index, and slice (R)'s launches at the shapes no other slice gives
(``knob_launches``: strided groups in training, FP4 and its backward at
``--width-mult`` 2 and 4, a bfloat16 gradient). Run as a script,
this module times those cases alone
(``--kernels`` picks some kernels), importing ``gspn_tpu_torch`` from
``--tree DIR`` (another checkout, for example the parent commit unpacked
with ``git archive``), so that two versions of the kernels compare on one
card in one call: run it for the parent, the change, the change and the
parent in turn. Each line gives the kernel's device time (20 calls after
a warm-up), all the device work of a call and its device operations (a
tree whose entry point launches more than the kernel, such as the
parent's two one-way argmins or its interpolation's weights and concat
before ``nn_argmin_pair`` and ``three_interpolate_fp``, is timed through
that composite: ``FALLBACKS``), and the wrapper's time (the median of
three windows of 20), with the card's name and power limit; every kernel
output is first held bitwise against the plain version. Needs a CUDA
device.

Nothing here imports ``gspn_tpu_torch`` at module level: the script's
``--tree`` decides which one it times.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import statistics
import subprocess
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
ITERS = 20  # timed launches a case
CUDA_WINDOWS = 3  # cuda_ms's windows of timed launches
PROFILER_WINDOWS = 8  # tries at a complete profiler window (window_complete)
SPIN_KERNEL, SPIN_CYCLES = "spin_kernel", 1000  # a window's brackets (torch.cuda._sleep)
# the kernels' device symbols, before and after their redesigns, so that
# either tree's kernels are found
# the ball scans' kernels at 1-4 scales with coordinates (the ball groups) and
# without (the ball queries): group_first_kernel<gspn::Ball<1>, true>, ...
BALL_SCANS = {
    (name, coords): tuple(f"{name}<gspn::Ball<{s}>, {coords}>" for s in range(1, 5))
    for name in ("group_first_kernel", "group_strided_kernel") for coords in ("true", "false")
}
SYMBOLS = {
    "fps": ("fps_kernel",), "fps_cluster": ("fps_cluster_kernel",),
    "ball_group": BALL_SCANS["group_first_kernel", "true"] + (
        "group_first_kernel<gspn::Ball", "ball_group_first_kernel",
        "group_scan_kernel<false, false, true>"),
    "ball_group_strided": BALL_SCANS["group_strided_kernel", "true"] + (
        "group_strided_kernel<gspn::Ball", "group_scan_kernel<false, true, true>"),
    "box_group": ("group_first_kernel<gspn::Box", "group_scan_kernel<true, false, true>"),
    "box_group_strided": ("group_strided_kernel<gspn::Box", "group_scan_kernel<true, true, true>"),
    "ball_query": BALL_SCANS["group_first_kernel", "false"] + ("group_scan_kernel<false>",),
    "ball_query_strided": BALL_SCANS["group_strided_kernel", "false"] + (
        "group_scan_kernel<true>",),
    "nms": ("nms_kernel",), "three_nn": ("three_nn_kernel",),
    "interp_mm": ("interp_mm_kernel",),
    "mask_project": ("nearest_logit_kernel<false>", "mask_project_kernel<false>"),
    "mask_project_boxed": ("nearest_logit_kernel<true>", "mask_project_kernel<true>"),
    "nn_argmin": ("nn_argmin_kernel",), "index_add": ("index_add_kernel",),
}
# the training BatchNorm's kernels (namespace gspn_bn), each launched once a
# layer and step, and their entry points in ``gspn_tpu_torch.ops``
BN_SYMBOLS = {"bn_stats": ("bn_stats_kernel",), "bn_apply": ("bn_apply_kernel",),
              "bn_grad_terms": ("bn_grad_terms_kernel",),
              "bn_grad_input": ("bn_grad_input_kernel",)}
BN_ENTRY_POINTS = {"bn_stats": "batch_norm_stats", "bn_apply": "batch_norm_apply",
                   "bn_grad_terms": "batch_norm_grad_terms",
                   "bn_grad_input": "batch_norm_grad_input"}
# (rows, channels, masked) of the training cells' BatchNorm layers: stage
# 1's largest crop (16 x 64 seeds x K 256, 256 channels), stage 2's SA1
# (32 x 1024 centres x K 32, 32 channels) and recog_enc's GT points (16 x 64
# seeds x 256, 64 channels, weighted by their validity)
BN_SHAPES = ((262144, 256, False), (1048576, 32, False), (262144, 64, True))
BN_EPS, BN_MOMENTUM = 1e-3, 0.9  # nn/layers.py MaskedBatchNorm's


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Device time of ``fn`` a call by CUDA events: the median over
    ``CUDA_WINDOWS`` windows of the mean over ``iters`` calls each, after a
    warm-up. A call whose host work outlasts its kernel is timed by the
    host, which the machine shares: the median keeps a window that other
    work interrupted from setting the figure."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    windows = []
    for _ in range(CUDA_WINDOWS):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        windows.append(start.elapsed_time(end) / iters)
    return statistics.median(windows)


def _launch_total() -> int:
    """Launches of every hand-written kernel so far, by the ctypes
    library's own counter (``ops._cuda.KERNELS``), in the tree imported."""
    from gspn_tpu_torch.ops import _cuda

    return sum(k.launches for k in _cuda.KERNELS.values())


def kernel_event(name: str) -> bool:
    """Whether a device event's name is a hand-written kernel's
    (``SYMBOLS``, ``BN_SYMBOLS``)."""
    return any(sym in name for table in (SYMBOLS, BN_SYMBOLS) for syms in table.values()
               for sym in syms)


def window_complete(names: list[str], launched: int) -> bool:
    """Whether a profiler window kept every record: ``names``, its device
    events' names in start order, end with the closing spin, and, where the
    window's calls launched ``launched`` hand-written kernels by the
    library's counter, hold as many events of those kernels. A launch the
    counter does not see (a CUDA graph's replay) leaves ``launched`` at 0,
    and then only the closing spin is checked."""
    if not names or SPIN_KERNEL not in names[-1]:
        return False
    return not launched or sum(map(kernel_event, names)) == launched


def _device_events(fn, iters: int):
    """The device events of a profiler window over ``iters`` calls of
    ``fn``, after a warm-up call. CUPTI loses records now and then (on an
    H100: the window's first kernel, whose launch asks for its first
    activity buffer, in about one window in 400, and in every window once
    a process has run long kernels; one record in the middle of a window;
    every kernel from some point on; or a whole window). So the window
    opens with a short spin kernel of its own (``torch.cuda._sleep``),
    which takes the first of those losses, and closes with another, whose
    record shows that the window's tail was kept; both are left out of the
    events. A window is taken again, up to ``PROFILER_WINDOWS`` times,
    unless :func:`window_complete`: it kept its closing spin, and its
    events of the hand-written kernels number the launches the ctypes
    library counted during its calls. The last window is returned, with a
    printed line, if none was complete."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_WINDOWS):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            before = _launch_total()
            for _ in range(iters):
                fn()
            launched = _launch_total() - before
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        device = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        mine = [e for e in device if SPIN_KERNEL not in e.name]
        if window_complete([e.name for e in device], launched):
            return mine
    print(f"profiler: none of {PROFILER_WINDOWS} windows was complete (closing spin, "
          f"{launched} kernel launches counted); {len(mine)} events over {iters} calls")
    return mine


def device_launches(fn, iters: int) -> float:
    """Device operations (kernels, copies, fills) a call of ``fn`` makes,
    from ``torch.profiler`` over ``iters`` calls."""
    return len(_device_events(fn, iters)) / iters


def _span_ms(events) -> float:
    return sum(e.time_range.end - e.time_range.start for e in events) / 1e3


def device_profile(fn, iters: int, symbols: tuple[str, ...]):
    """One profiler window over ``iters`` calls of ``fn`` after a warm-up:
    ``(the kernel's mean device ms an event, its events, all device ms a
    call, device operations a call)``, the kernel being any of
    ``symbols``; its ms is None (with a printed line) when no window
    recorded it."""
    device = _device_events(fn, iters)
    mine = [e for e in device if any(sym in e.name for sym in symbols)]
    if not mine:
        print(f"profiler: no device event of {symbols} among {sorted({e.name for e in device})}")
    kernel_ms = _span_ms(mine) / len(mine) if mine else None
    return kernel_ms, len(mine), _span_ms(device) / iters, len(device) / iters


def device_ms(fn, iters: int, symbols: tuple[str, ...]) -> tuple[float | None, int]:
    """``(mean device ms per call, events)`` of the kernel (any of
    ``symbols``) over ``iters`` calls of ``fn`` after a warm-up, from
    ``torch.profiler``'s device events: the kernel alone, without its
    wrapper's host work or other device work. Every wrapper of this
    repository launches its kernel once a call, so an event is a call.
    ``(None, 0)`` means no window recorded the kernel (its launches and
    outputs are checked apart from this)."""
    return device_profile(fn, iters, symbols)[:2]


def max_abs_err(got, want) -> float:
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


def flatten(outs) -> list:
    """A kernel's outputs (a tensor, or nested tuples and lists of them)
    as one list of tensors."""
    if isinstance(outs, torch.Tensor):
        return [outs]
    return [t for o in outs for t in flatten(o)]


# each kernel's entry point in ``gspn_tpu_torch.ops``, and its keywords
ENTRY_POINTS = {
    "fps": "farthest_point_sample", "fps_cluster": "farthest_point_sample",
    "ball_group": "query_ball_group_multi", "ball_group_strided": "query_ball_group_multi",
    "box_group": "query_box_group", "box_group_strided": "query_box_group",
    "ball_query": "query_ball_point_multi", "ball_query_strided": "query_ball_point_multi",
    "nms": "nms_3d_batched", "three_nn": "three_nn",
    "interp_mm": "three_interpolate_fp", "mask_project": "nearest_sample_logit",
    "mask_project_boxed": "nearest_sample_logit_boxed",
    "nn_argmin": "nn_argmin_pair", "index_add": "index_add_rows",
}
KEYWORDS = {name: {"select": "strided"}
            for name in ("ball_group_strided", "box_group_strided", "ball_query_strided")}
REQUESTS = ("B8xN8192", "B1xN65536")  # bench_slice.SHAPES: flagship, whole scene
TRAIN_SHAPE = "B4xN4096"  # slices (G) and (I): bench_slice.TRAIN_BATCH x TRAIN_POINTS
STEP_SLICES = ("G", "I")  # ranked a training step each, at TRAIN_SHAPE
# the slices ranked launch by launch (chip_smoke.py): the main path (A),
# its box-pruned projection (B), strided selection (E), the exact FPS (H)
# a request each; the ball-query entry points (F) a pass at each shape;
# stage-1 (G) and stage-2 (I) training a step
RANKED = ("A", "B", "E", "F", "G", "H", "I")
ROIS, ROI_SAMPLES = 64, 64  # seeds (RoIs) a scene, in-box samples a RoI
CROPS = ((0.25, 0.5, 1.0), (32, 64, 128))  # GSPN context crops: radii, K


def request_key(slice_name: str, shape: str) -> str:
    """The key of one request (a pass, a step) of a ranked slice: ``"(A)
    B8xN8192"``."""
    return f"({slice_name}) {shape}"


def ranked_keys() -> list[str]:
    """Every ranked slice's request keys: both request shapes, the training
    slices' batch."""
    return [request_key(s, shape) for s in RANKED
            for shape in ((TRAIN_SHAPE,) if s in STEP_SLICES else REQUESTS)]


def chamfer_inputs(ops, bench_slice, dev, gen):
    """The training step's chamfer inputs, flattened over (scene, seed):
    the GT instances ``gather_seed_instances`` pairs with the 64 FPS seeds
    of ``bench_slice.train_batch`` (256 points each, with their real
    validity) and as many predicted points drawn about each seed."""
    from gspn_tpu_torch.data.instances import gather_seed_instances

    tb = bench_slice.train_batch(dev)
    seeds = ops.farthest_point_sample(bench_slice.TRAIN_SEEDS, tb["xyz"], tb["valid"])
    gt, gt_valid, _, _ = gather_seed_instances(tb["xyz"], tb["inst_label"], seeds,
                                               bench_slice.TRAIN_GT)
    b, s, g, _ = gt.shape
    noise = (torch.randn((b, s, g, 3), generator=gen) * 0.3).to(dev)
    pred = ops.gather_point(tb["xyz"], seeds)[:, :, None, :] + noise
    return pred.reshape(b * s, g, 3), gt.reshape(b * s, g, 3), gt_valid.reshape(b * s, g)


def _pair_of_argmins(ops, xyz1, xyz2, valid1, valid2, *, impl):
    return (ops.nn_argmin(xyz1, xyz2, valid2, impl=impl),
            ops.nn_argmin(xyz2, xyz1, valid1, impl=impl))


def _fp_composite(ops, points2, idx, dist, points1, *, impl):
    out = ops.three_interpolate_mm(points2, idx, ops.three_interpolate_weights(dist), impl=impl)
    return out if points1 is None else torch.cat([out, points1], dim=-1)


# what a tree older than an entry point runs in its place: the chamfer's two
# one-way argmins, the FP module's weights, interpolation and concat
FALLBACKS = {"nn_argmin_pair": _pair_of_argmins, "three_interpolate_fp": _fp_composite}


def call(ops, name: str, args, impl: str):
    """The entry point of kernel ``name`` (a key of ``ENTRY_POINTS``) on a
    case's ``args``, or its ``FALLBACKS`` composite in a tree without it."""
    entry = ENTRY_POINTS[name]
    if not hasattr(ops, entry):
        return FALLBACKS[entry](ops, *args, impl=impl)
    return getattr(ops, entry)(*args, impl=impl, **KEYWORDS.get(name, {}))


SPLITS = (1, 2, 4, 8, 16)  # warps a query the ball and box groups take
# three_nn: targets a thread, source slices, sources a group
NN_PER, NN_SPLITS, NN_GROUPS = (1, 2, 4), (1, 2, 4, 8, 16, 32), (1, 32)
# the FP interpolation: rows a task and slices (direct), rows a chunk
# (staged); the two-way argmin: CTAs a row
FP_ROWS, FP_SLICES, FP_CHUNKS = (1, 2, 4, 8), (1, 2, 3, 4, 6), (512, 1024, 2048)
NN_CTAS = (1, 2, 4, 8, 12, 16)


def forced_plans(name: str, args) -> dict:
    """``{plan: launch()}``: kernel ``name`` on a case's ``args`` (in
    ``cases``' layout) at each plan its launcher can be forced to, the
    wrapper's own pick among them; ``{}`` for a kernel without one.
    fps_cluster: each cluster size of two or more CTAs that holds the rows;
    the ball and box groups: each split (warps a query), and for the
    strided ones also "direct" (a warp a query reading the scene); three_nn:
    each "targets a thread x source slices x sources a group"; interp_mm
    (from the distances): each "rows x slices x 0" (direct) and, without
    skip rows, each "rows a chunk x slices x 32" (staged) whose sources fit
    in shared memory; nn_argmin (both ways): each count of CTAs a row up
    to the row's tiles of targets."""
    import functools
    import itertools

    from gspn_tpu_torch.ops import box_group as tbox
    from gspn_tpu_torch.ops import chamfer as tchamfer
    from gspn_tpu_torch.ops import fps as tfps
    from gspn_tpu_torch.ops import interpolate as tinterp
    from gspn_tpu_torch.ops.ball_group import _ball_group_cuda, _ball_group_strided_cuda

    part = functools.partial
    if name == "fps_cluster":
        npoint, xyz, valid = args
        return {cs: part(tfps._fps_cuda, xyz, npoint, valid, cluster=cs)
                for cs in tfps.FPS_CLUSTER_SIZES[1:] if -(-xyz.shape[1] // cs) <= tfps.FPS_MAX_N}
    if name == "ball_group":
        return {s: part(_ball_group_cuda, *args, split=s) for s in SPLITS}
    if name == "box_group":
        return {s: part(tbox._box_group_cuda, tbox.KERNEL, *args, s) for s in SPLITS}
    strided = {"ball_group_strided": _ball_group_strided_cuda,
               "box_group_strided": tbox._box_group_strided_cuda}
    if name in strided:
        return {s: part(strided[name], *args, plan=(1, True) if s == "direct" else (s, False))
                for s in SPLITS + ("direct",)}
    if name == "three_nn":
        return {"x".join(map(str, p)): part(tinterp._three_nn_cuda, *args, plan=p)
                for p in itertools.product(NN_PER, NN_SPLITS, NN_GROUPS)}
    if name == "interp_mm":
        pts, idx, _, skip = args
        b, n, m, c = idx.shape[0], idx.shape[1], pts.shape[1], pts.shape[2]
        c1 = 0 if skip is None else skip.shape[-1]
        plans = list(itertools.product(FP_ROWS, FP_SLICES, (0,)))
        if c1 == 0:
            st = tinterp.INTERP_MM_STAGE
            plans += [(chunk, c // st, st) for chunk in FP_CHUNKS
                      if c % st == 0 and m * st * 4 + chunk * 32 <= tinterp.INTERP_MM_SMEM]
        picked = tinterp.interp_mm_plan(b, n, m, c, c1)
        plans += [picked] * (picked not in plans)
        return {"x".join(map(str, p)): part(tinterp._interp_mm_cuda, *args, from_dist=True,
                                            plan=p) for p in plans}
    if name == "nn_argmin":  # at most a CTA a tile of a row's targets
        tiles = -(-args[0].shape[1] // tchamfer.NN_ARGMIN_TARGETS)
        return {ctas: part(tchamfer._argmin_cuda, *args, both=True, ctas=ctas)
                for ctas in NN_CTAS if ctas <= tiles}
    return {}


def main_path_inputs(ops, bench_slice, dev) -> dict:
    """``{request: dict}`` for the flagship and the whole-scene request
    (``bench_slice``'s scenes): the scene (``xyz``, ``valid``), its
    Morton-sorted view (``sxyz``, ``svalid``), the 64 ``seeds`` of 8
    spatial FPS chains, the SA centres of every level (``sa``: SA1-SA4,
    each level's FPS as the backbone runs it), ``boxes`` about the seeds
    with half-sizes in [0.1, 0.6), their first 64 in-box points as RoI
    samples (``roi_xyz``), random mask ``logits`` and NMS ``scores``, and
    the generator ``gen`` (a fixed seed) that drew them."""
    gen = torch.Generator().manual_seed(0)
    out = {}
    for shape in REQUESTS:
        xyz, valid = (torch.from_numpy(a).to(dev) for a in bench_slice.scenes(shape))
        b = xyz.shape[0]
        sxyz, svalid, sidx = ops.spatial_sorted_view(xyz, valid)
        seeds = ops.gather_point(xyz, torch.gather(sidx, 1, ops.farthest_point_sample(
            ROIS, sxyz, svalid, segments=8, segment_mode="contiguous").long()))
        sa = [ops.gather_point(xyz, ops.farthest_point_sample(
            1024, xyz, valid, segments=8, segment_mode="spatial"))]
        for npoint in (256, 64, 16):
            src = sa[-1]
            segs = ops.eligible_fps_segments(8, npoint, src.shape[1])
            sa.append(ops.gather_point(src, ops.farthest_point_sample(
                npoint, src, segments=segs, segment_mode="spatial")))
        half = (torch.rand((b, ROIS, 3), generator=gen) * 0.5 + 0.1).to(dev)
        boxes = torch.cat([seeds - half, seeds + half], dim=-1)
        roi_xyz = ops.query_box_group(boxes, ROI_SAMPLES, xyz, valid)[2] + (
            (boxes[..., 0:3] + boxes[..., 3:6]) * 0.5)[..., None, :]
        logits = (torch.randn((b, ROIS, ROI_SAMPLES), generator=gen) * 0.1).to(dev)
        scores = torch.rand((b, ROIS), generator=gen).to(dev)
        out[shape] = dict(xyz=xyz, valid=valid, sxyz=sxyz, svalid=svalid, seeds=seeds, sa=sa,
                          boxes=boxes, roi_xyz=roi_xyz, logits=logits, scores=scores, gen=gen)
    return out


def cases(ops, bench_slice, dev, inputs=None) -> dict:
    """``{kernel: [(label, args, requests)]}``: every launch of the ranked
    slices' kernels in one flagship and one whole-scene request (a pass of
    (F) at each shape, a step of (G)), at its own shape, each tagged with
    the ``requests`` (keys of ``request_key``) that make it; the first case
    of each kernel is the shape ``chip_smoke.py`` reports. (A), (B) and
    (E): fps's shared pass (eight spatial chains, also (F)'s) and SA2-SA4;
    (A), (B) and (H) the first-K ball group at SA1, the crops and SA2-SA4
    and the first-S box group, (E) the strided ones at the same shapes;
    (H): fps over whole rows (the shared pass of 1024 picks at the
    flagship, on fps_cluster at the whole scene, and SA2-SA4); (A), (B),
    (E), (H): nms, three_nn and interp_mm (from the distances, with the
    skip concat at FP1-FP3) at FP4, FP1-FP3; mask_project
    once a request of (A), (E), (H), mask_project_boxed on the
    Morton-sorted view in (B); (F): ball_query_strided at SA1 and the
    crops, ball_query at SA1, with the ball groups' labels; (G): the seeds'
    fps, the crops' ball_group, nn_argmin both ways in one launch (pred ->
    GT masked, GT -> pred), index_add at the chamfer's gather backward;
    (I): ``stage2_launches``. Untagged: index_add with 512 positions on
    each of 8 indices. ``inputs``: ``main_path_inputs``' result, made here
    if None."""
    inputs = inputs or main_path_inputs(ops, bench_slice, dev)
    out = {name: [] for name in ENTRY_POINTS}
    gen = torch.Generator().manual_seed(1)
    for shape in REQUESTS:
        x = inputs[shape]
        xyz, valid, sxyz, svalid, sa = x["xyz"], x["valid"], x["sxyz"], x["svalid"], x["sa"]
        b, n = xyz.shape[:2]
        tag = "" if b > 1 else ", whole scene"

        def add(name, label, args, slices="ABEH"):
            out[name].append((label + tag, args, tuple(request_key(s, shape) for s in slices)))

        def add_group(name, label, args):  # (A), (B), (H) first-K, (E) strided
            add(name, label, args, "ABH")
            add(f"{name}_strided", label, args, "E")

        add("fps", f"shared pass: {b * 8} chains x {n // 8} pts, 128 picks",
            (128, sxyz.reshape(b * 8, n // 8, 3), svalid.reshape(b * 8, n // 8)), "ABEF")
        add("fps" if n <= 8192 else "fps_cluster",
            f"exact shared pass: {b} x {n} pts, 1024 picks", (1024, xyz, valid), "H")
        sa1 = (f"sa1: {b}x1024 q over {n}, r 0.1, K 32", ((0.1,), (32,), xyz, sa[0], valid))
        crops = (f"gspn crops: {b}x64 seeds, r .25/.5/1, K 32/64/128",
                 (*CROPS, xyz, x["seeds"], valid))
        add_group("ball_group", *sa1)
        add_group("ball_group", *crops)
        add("ball_query", *sa1, "F")
        add("ball_query_strided", *sa1, "F")
        add("ball_query_strided", *crops, "F")
        for lvl, r in ((1, 0.2), (2, 0.4), (3, 0.8)):
            src, npoint = sa[lvl - 1], sa[lvl].shape[1]
            segs = ops.eligible_fps_segments(8, npoint, src.shape[1])
            chains = ops.spatial_sorted_view(src, None)[0] if segs > 1 else src
            chains = chains.reshape(b * segs, src.shape[1] // segs, 3)
            add("fps", f"sa{lvl + 1}: {chains.shape[0]} x {chains.shape[1]} pts, "
                f"{npoint // segs} picks", (npoint // segs, chains, None),
                "ABE" if segs > 1 else "ABEH")
            if segs > 1:  # (H) samples the level in one chain
                add("fps", f"exact sa{lvl + 1}: {b} x {src.shape[1]} pts, {npoint} picks",
                    (npoint, src, None), "H")
            add_group("ball_group", f"sa{lvl + 1}: {b}x{npoint} q over {src.shape[1]}, "
                      f"r {r}, K 32", ((r,), (32,), src, sa[lvl], None))
        add_group("box_group", f"{b}x{ROIS} RoIs over {n}, S {ROI_SAMPLES}",
                  (x["boxes"], ROI_SAMPLES, xyz, valid))
        add("nms", f"{b}x{ROIS} RoI boxes, random scores, IoU 0.25",
            (x["boxes"], x["scores"], 0.25))
        # FP level i interpolates SA level 4-i+1's features onto level
        # 4-i's points (level 0: the scene) and appends level 4-i's own
        # features (none at the scene); C: the source level's channels, C1
        # the target level's
        levels = [xyz] + sa
        for fp, c, c1 in ((4, 128, 0), (1, 512, 256), (2, 256, 128), (3, 256, 64)):
            tgt, src = levels[4 - fp], levels[5 - fp]
            dist, idx = ops.three_nn(tgt, src)
            feats = torch.randn((b, src.shape[1], c), generator=x["gen"]).to(dev)
            skip = (torch.randn((b, tgt.shape[1], c1), generator=x["gen"]).to(dev)
                    if c1 else None)
            pair = f"{b}x{tgt.shape[1]} <- {src.shape[1]}"
            add("three_nn", f"fp{fp}: {pair}", (tgt, src, None))
            add("interp_mm", f"fp{fp}: {pair}, C {c}" + (f" + skip {c1}" if c1 else ""),
                (feats, idx, dist, skip))
        add("mask_project", f"{b}x{ROIS} RoIs x {n} pts, S {ROI_SAMPLES}",
            (xyz, x["roi_xyz"], x["logits"]), "AEH")
        add("mask_project_boxed", f"Morton-sorted {b}x{ROIS} RoIs x {n} pts, S {ROI_SAMPLES}",
            (sxyz, x["roi_xyz"], x["logits"], x["boxes"], None, svalid), "B")

    # (G): one training step
    def add_step(name, label, args):
        out[name].append((label, args, (request_key("G", TRAIN_SHAPE),)))

    tb = bench_slice.train_batch(dev)
    tseeds = ops.gather_point(tb["xyz"], ops.farthest_point_sample(64, tb["xyz"], tb["valid"]))
    add_step("fps", "training seeds: 4 x 4096 pts, 64 picks", (64, tb["xyz"], tb["valid"]))
    add_step("ball_group", "training crops: 4x64 seeds over 4096, K 64/128/256",
             ((0.25, 0.5, 1.0), (64, 128, 256), tb["xyz"], tseeds, tb["valid"]))
    pred, gt, gt_valid = chamfer_inputs(ops, bench_slice, dev, gen)
    add_step("nn_argmin", "chamfer pred <-> GT: 256 rows x 256 <- 256 both ways, GT masked",
             (pred, gt, None, gt_valid))
    grad = torch.randn(pred.shape, generator=gen).to(dev)
    add_step("index_add", "chamfer backward: 256 rows x 256 GT -> pred positions, C 3",
             (grad, ops.nn_argmin(gt, pred), pred.shape[1]))
    # (I): one stage-2 training step
    for name, label, args in stage2_launches(ops, bench_slice, dev, gen):
        out[name].append((label, args, (request_key("I", TRAIN_SHAPE),)))
    # (R): the trainers' knobs, untagged
    for name, label, args in knob_launches(ops, bench_slice, dev, gen):
        out[name].append((label, args, ()))
    out["index_add"].sort(key=lambda case: not case[2])  # the steps' cases first
    crowd = torch.randint(0, 8, (16, 4096), generator=gen, dtype=torch.int32).to(dev)
    out["index_add"].append(("16 x 4096 positions -> 8 (512 on each), C 64",
                             (torch.randn((16, 4096, 64), generator=gen).to(dev), crowd, 8), ()))
    return out


def bn_cases(ops, dev, shapes=BN_SHAPES) -> dict:
    """``{kernel: [(label, args, keywords)]}``: the training BatchNorm's four
    kernels at each ``(rows, channels, masked)`` of ``shapes``, on one
    layer's inputs from a fixed seed: ``x`` about a per-channel offset, the
    output's gradient ``g``, a quarter of the rows masked out where
    ``masked``, the ReLU on; the statistics, the backward's terms and their
    column sums from the plain versions. ``bn_stats`` leaves the running
    statistics as they are (``update`` False). Call one with
    :func:`bn_call`."""
    gen = torch.Generator().manual_seed(2)
    out = {name: [] for name in BN_ENTRY_POINTS}
    for rows, c, masked in shapes:
        label = f"{rows} x {c}{', masked' if masked else ''}, ReLU"
        x = (torch.randn((rows, c), generator=gen) + torch.randn(c, generator=gen)).to(dev)
        g = torch.randn((rows, c), generator=gen).to(dev)
        mask = (torch.rand(rows, generator=gen) > 0.25).to(dev) if masked else None
        scale = (torch.rand(c, generator=gen) + 0.5).to(dev)
        bias = (torch.randn(c, generator=gen) * 0.1).to(dev)
        running = (torch.zeros(c, device=dev), torch.ones(c, device=dev))
        stats = ops.batch_norm_stats(x, mask, *running, eps=BN_EPS, momentum=BN_MOMENTUM,
                                     update=False, impl="plain")
        _, _, tr, td = ops.batch_norm_grad_terms(x, g, stats, scale, bias, relu=True,
                                                 impl="plain")
        out["bn_stats"].append((label, (x, mask, *running),
                                {"eps": BN_EPS, "momentum": BN_MOMENTUM, "update": False}))
        out["bn_apply"].append((label, (x, stats, scale, bias), {"relu": True}))
        out["bn_grad_terms"].append((label, (x, g, stats, scale, bias), {"relu": True}))
        out["bn_grad_input"].append((label, (x, td, mask, stats, tr.sum(dim=0), td.sum(dim=0)),
                                     {}))
    return out


def bn_call(ops, name: str, args, keywords: dict, impl: str):
    """The entry point of BatchNorm kernel ``name`` on a :func:`bn_cases`
    case."""
    return getattr(ops, BN_ENTRY_POINTS[name])(*args, impl=impl, **keywords)


def stage2_launches(ops, bench_slice, dev, gen, configs=None) -> list:
    """``[(kernel, label, args)]``: every kernel launch of one stage-2
    training step (``chip_smoke.py`` slice (I): ``bench_slice``'s stage-2
    configs, or ``configs`` = (frozen GSPN, R-PointNet), on
    ``train_batch``), at the shapes the step gives it: the shared
    exact FPS pass (the 64 seeds and SA1's 1024 centres) and SA2-SA4's; the
    frozen GSPN's crops and SA1-SA4's ball groups; the RoIAlign box group
    over the seeded frozen GSPN's 64 proposals and the 16 jittered GT boxes
    a scene; three_nn and interp_mm at FP1-FP4 (features and skip rows
    random, drawn from ``gen``); and the backward's index_add: SA2-SA4's
    feature gathers, FP1-FP4's interpolation into their sources and the
    RoIAlign gather of the backbone's features, each at the step's own
    indices (gradients random)."""
    from gspn_tpu_torch.models.gspn import proposal_boxes
    from gspn_tpu_torch.models.rpointnet import instance_gt_boxes, point_roi_align

    gcfg, rcfg = configs or bench_slice.stage2_configs()
    tb = bench_slice.train_batch(dev)
    xyz, valid = tb["xyz"], tb["valid"]
    b, n = xyz.shape[:2]
    seeds_n, sa = bench_slice.TRAIN_SEEDS, rcfg.sa_layers
    rand = lambda *shape: torch.randn(shape, generator=gen).to(dev)  # noqa: E731
    fps_all = ops.farthest_point_sample(max(seeds_n, sa[0].npoint), xyz, valid)
    out = [("fps", f"stage 2 shared pass: {b} x {n} pts, {fps_all.shape[1]} picks",
            (fps_all.shape[1], xyz, valid))]
    seed_idx = fps_all[:, :seeds_n]
    radii = "/".join(f"{r:g}" for r in gcfg.context_radii)
    ks = "/".join(map(str, gcfg.context_nsample))
    out.append(("ball_group", f"stage 2 frozen GSPN crops: {b}x{seeds_n} seeds over {n}, "
                f"r {radii}, K {ks}", (gcfg.context_radii, gcfg.context_nsample, xyz,
                                       ops.gather_point(xyz, seed_idx), valid)))
    with torch.no_grad():
        gen_pts = bench_slice.seeded_frozen_gspn(gcfg, dev)(
            xyz, seed_idx, valid, z_eps=rand(b, seeds_n, gcfg.latent_dim)).generated
    gt, _, present = instance_gt_boxes(xyz, tb["inst_label"], tb["sem_label"],
                                       bench_slice.STAGE2_INSTANCES)
    gt_rois = torch.where(present[..., None], gt + rand(*gt.shape) * 0.05, torch.zeros_like(gt))
    rois = torch.cat([proposal_boxes(gen_pts, rcfg.box_margin), gt_rois], dim=1)
    grads = []  # the backward's index_add launches, after the forward's
    levels, valids, chans = [xyz], [valid], [0]
    for i, spec in enumerate(sa):
        src, sv = levels[-1], valids[-1]
        if i:
            out.append(("fps", f"stage 2 sa{i + 1}: {b} x {src.shape[1]} pts, {spec.npoint} picks",
                        (spec.npoint, src, sv)))
        idx = fps_all[:, :spec.npoint] if i == 0 else ops.farthest_point_sample(
            spec.npoint, src, sv)
        centres = ops.gather_point(src, idx)
        args = ((spec.radius,), (spec.nsample,), src, centres, sv)
        out.append(("ball_group", f"stage 2 sa{i + 1}: {b}x{spec.npoint} q over {src.shape[1]}, "
                    f"r {spec.radius}, K {spec.nsample}", args))
        ((gidx, cnt, _),) = ops.query_ball_group_multi(*args)
        if i:  # the level's input features are gathered: C of the level below
            grads.append((f"stage 2 sa{i + 1} grouping backward: {b} x {spec.npoint}x"
                          f"{spec.nsample} positions -> {src.shape[1]}, C {chans[-1]}",
                          (rand(b, gidx.shape[1] * spec.nsample, chans[-1]),
                           gidx.reshape(b, -1), src.shape[1])))
        levels.append(centres)
        valids.append(cnt > 0)
        chans.append(spec.mlp[-1])
    box_args = (rois, rcfg.roi_samples, xyz, valid)
    feat_c = chans[-1]
    for i, mlp in enumerate(rcfg.fp_mlps):
        lvl = len(sa) - 1 - i  # target level; its source is lvl + 1
        tgt, src, sv = levels[lvl], levels[lvl + 1], valids[lvl + 1]
        m, c1 = src.shape[1], chans[lvl]
        pair = f"{b}x{tgt.shape[1]} <- {m}"
        dist, nidx = ops.three_nn(tgt, src, sv)
        out.append(("three_nn", f"stage 2 fp{i + 1}: {pair}", (tgt, src, sv)))
        out.append(("interp_mm", f"stage 2 fp{i + 1}: {pair}, C {feat_c}"
                    + (f" + skip {c1}" if c1 else ""),
                    (rand(b, m, feat_c), nidx, dist, rand(b, tgt.shape[1], c1) if c1 else None)))
        grads.append((f"stage 2 fp{i + 1} backward: {b} x {tgt.shape[1]}x3 positions -> {m}, "
                      f"C {feat_c}", (rand(b, tgt.shape[1] * 3, feat_c), nidx.reshape(b, -1), m)))
        feat_c = mlp[-1]
    out.append(("box_group", f"stage 2 RoIAlign: {b}x{rois.shape[1]} RoIs over {n}, "
                f"S {rcfg.roi_samples}", box_args))
    roi_idx = point_roi_align(xyz, rois, rcfg.roi_samples, valid)[0]
    grads.append((f"stage 2 RoIAlign backward: {b} x {rois.shape[1]}x{rcfg.roi_samples} "
                  f"positions -> {n}, C {feat_c}",
                  (rand(b, roi_idx.shape[1] * rcfg.roi_samples, feat_c),
                   roi_idx.reshape(b, -1), n)))
    return out + [("index_add", label, args) for label, args in reversed(grads)]


def knob_launches(ops, bench_slice, dev, gen) -> list:
    """``[(kernel, label, args)]``: the launches of slice (R) (the trainers'
    ``--group-select strided``, ``--width-mult`` and ``--dtype bf16`` at
    full width) at shapes no other slice gives their kernel: the strided
    ball group at (G)'s crops and the strided ball and box groups at every
    launch of a stage-2 step (the frozen GSPN's crops, SA1-SA4, the
    RoIAlign's 80 RoIs a scene); at ``--width-mult`` 2 and 4, FP4's
    interpolation (C 256 and 512, the staged form) and the index_add of
    its backward and of the RoIAlign's; and the RoIAlign backward's
    index_add at (I)'s shape with a bfloat16 gradient, which the gather's
    backward sums in float32 (its values rounded to bfloat16 here)."""
    from gspn_tpu_torch.models.presets import scale_gspn_widths, scale_rpointnet_widths

    tb = bench_slice.train_batch(dev)
    tseeds = ops.gather_point(tb["xyz"], ops.farthest_point_sample(64, tb["xyz"], tb["valid"]))
    b, n = tb["xyz"].shape[:2]
    out = [("ball_group_strided", f"(R-strided) training crops: {b}x64 seeds over {n}, "
            "K 64/128/256", ((0.25, 0.5, 1.0), (64, 128, 256), tb["xyz"], tseeds, tb["valid"]))]
    strided = {"ball_group": "ball_group_strided", "box_group": "box_group_strided"}
    for name, label, args in stage2_launches(ops, bench_slice, dev, gen):
        if name in strided:
            out.append((strided[name], f"(R-strided) {label}", args))
        if name == "index_add" and "RoIAlign" in label:
            out.append((name, f"(R-bf16) {label}, a bfloat16 gradient",
                        (args[0].bfloat16().float(), *args[1:])))
    gcfg, rcfg = bench_slice.stage2_configs()
    for mult in (2, 4):
        wide = (scale_gspn_widths(gcfg, mult), scale_rpointnet_widths(rcfg, mult))
        for name, label, args in stage2_launches(ops, bench_slice, dev, gen, wide):
            if name in ("interp_mm", "index_add") and ("fp4" in label or "RoIAlign" in label):
                out.append((name, f"(R-wide x{mult}) {label}", args))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(REPO), help="checkout whose gspn_tpu_torch is timed")
    ap.add_argument("--kernels", default=",".join(SYMBOLS),
                    help="comma-separated kernels to time (default: all)")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree]
    from gspn_tpu_torch import ops
    from gspn_tpu_torch.utils import bench_slice

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: needs a CUDA device")
    if not ops.__file__.startswith(tree):
        raise SystemExit(f"time_kernels: imported {ops.__file__}, not from {tree}")
    card = card_name()
    bench_slice.pin_float32_matmuls()
    names = args.kernels.split(",")
    for name, items in cases(ops, bench_slice, torch.device("cuda", 0)).items():
        if name not in names:
            continue
        for label, a, _ in items:
            fn = lambda impl, a=a, name=name: call(ops, name, a, impl)  # noqa: E731
            max_abs_err(flatten(fn("cuda")), flatten(fn("plain")))
            dev_ms, events, call_ms, call_ops = device_profile(lambda fn=fn: fn("cuda"), ITERS,
                                                               SYMBOLS[name])
            ms = cuda_ms(lambda fn=fn: fn("cuda"), ITERS)
            print(f"time {name} [{label}] tree {args.tree}: device {dev_ms} ms over {events} "
                  f"events; a call: {call_ms:.4f} ms of device work in {call_ops:g} operations; "
                  f"wrapper {ms:.4f} ms; bitwise plain [{card}]", flush=True)


if __name__ == "__main__":
    main()
