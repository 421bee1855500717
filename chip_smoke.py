#!/usr/bin/env python3
"""Drive the PyTorch port's inference and training slices once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero without them. Phases,
each announced by a ``phase <name> at <seconds> s`` line and printing one
line or a few:

1. device: the card's name and power limit, CUDA and nvcc versions;
2. build: compiles the hand-written kernels (``gspn_tpu_torch/csrc``), one
   ``nvcc`` per source, all at once;
3. kernels: each of the nineteen kernels (fifteen point kernels and the
   training BatchNorm's four) against its plain PyTorch version at
   the slices' shapes, bitwise (integer outputs equal, floats bit for
   bit), with the wrapper's and the plain version's times from CUDA events
   over as many launches, the median of three windows (a plain version
   slower than 20 ms a call over ``PLAIN_SLOW_ITERS``), the kernel's own
   device time from
   ``torch.profiler``, the least time the card could take for the same
   work (``bound_ms``: the larger of the bytes over 3.35 TB/s and the
   operations over 33.5 T/s, counted from this run's inputs; see
   ``_bound``), and the time of one PyTorch call computing the same
   function where there is one (``library_ms`` at the first shape that
   has one, ``library_ms_by_shape`` for each shape and call timed; never
   called by the port); the timing helpers are ``gspn_tpu_torch.utils.time_kernels``;
   every kernel launch in one flagship and one whole-scene request of the
   ranked slices (A), (B), (E) and (H), one pass of (F) at each shape and
   one training step of (G), each at its own shape (``time_kernels.cases``:
   fps's shared pass and SA2-SA4, segmented in (A), (B), (E) and whole
   rows in (H), fps_cluster at (H)'s whole scene, the ball groups' crops
   and SA1-SA4 and the box group, first-K in (A), (B), (H) and strided in
   (E), NMS, three_nn and interp_mm at FP1-FP4 (``three_interpolate_fp``:
   the weights from the distances and, at FP1-FP3, the skip concat in the
   launch), mask_project, and mask_project_boxed on the sorted scenes in
   (B); (F)'s strided ball queries at SA1 and the crops and first-K at
   SA1; (G)'s seeds, crops, both chamfer argmins in one launch
   (``nn_argmin_pair``) and the gather backward ``index_add``), and the
   other form of two kernels (interp_mm from weights,
   ``three_interpolate_mm``, at FP4 and FP1; nn_argmin one way, and both
   ways at 16 rows x 4096 with ties), the BatchNorm's ``bn_stats``,
   ``bn_apply``, ``bn_grad_terms`` and ``bn_grad_input`` at the training
   cells' layer shapes (``time_kernels.bn_cases``: 262,144 x 256,
   1,048,576 x 32 and 262,144 x 64 masked; ``F.batch_norm`` and
   ``aten.native_batch_norm_backward`` as the library calls), with each
   shape's device and bound ms in ``device_ms_by_shape`` /
   ``bound_ms_by_shape``, every launch of one stage-2 training step of (I)
   at its own shape (``time_kernels.stage2_launches``), and index_add also
   with 512 positions an index; each (F) ball query's device ms
   beside the ball group's at the same shape; then, at each of their
   shapes but (I)'s, the ball
   and box groups, first-K and strided, at every split (warps a query),
   the strided groups' pick marked; three_nn at
   every (targets a thread, source slices, sources a group) plan; interp_mm
   at every (rows, slices, stage) plan; and nn_argmin both ways at every count of CTAs a row at 16
   rows x 4096; NMS's, index_add's, the FP interpolation's and the
   chamfer argmins' device operations a call (one) and wrapper ms at
   their ranked shapes; the exact FPS beyond one block
   (``fps_cluster``) also at 4 x 16384, 2 x 14273 with an all-invalid row
   and 131072 points, and at every cluster size that holds each of those
   rows and the whole scene's; NMS up to 4096 boxes and at 36,864;
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
   (H) ``scannet_pipeline(fps_segments=1)``, the exact greedy FPS, at both
   shapes: one ``fps_cluster`` launch per whole-scene request; and on the
   CPU's plain path a scene of 16384 points (the card's side on the cluster
   kernel);
5. slice (G), GSPN stage-1 training (``bench_slice.train_config()`` =
   ``GSPNConfig()`` at full width, B=4 x N=4096, 64 FPS seeds, 256 GT
   points per seed, Adam at 1e-3), outside ``torch.inference_mode``: first
   one step under ``torch.use_deterministic_algorithms(True,
   warn_only=True)`` on a model of its own, printing what PyTorch warns
   about; then one warm-up step and ``TRAIN_STEPS`` timed steps with the
   same noise each step, launch counts set to 0 just before (exactly fps,
   ball_group, nn_argmin (both ways) and the gather backward's index_add
   once a step, and the BatchNorm's four kernels once a trained layer and
   step: ``G_PER_STEP``), a second kernel-path run from the same weights that must be
   bitwise equal (losses, parameters, running statistics), then the plain
   path (a GSPN built from the plain config with the same initial
   weights), which launches nothing and must train the same model bit for
   bit (step 1's loss, terms and gradients, every later loss, the
   parameters and running statistics at the end), every loss finite,
   every running mean moved off 0; step 1 on the CPU's plain path on a
   small batch (B=1 x N=1024, 16 seeds, GT 64) within rtol 1e-4 of the
   card's; ``train_gspn.main`` at its defaults on the card for 3 steps,
   with 3 finite JSONL lines and a checkpoint; 4 steps straight against 2
   steps, a checkpoint and ``--resume`` for 2 more, bitwise; and
   ``--num-points 16384`` (exact FPS on the cluster kernel) for 3 steps;
   then slice (I), R-PointNet stage-2 training (``run_stage2``);
6. slice (J), serving (``run_serving``), after slice (I), in a process of
   its own (this script with ``--serving WORK``: the kernel phase's long
   library calls make CUPTI drop device records, and (J) counts device
   operations): at the flagship and the whole
   scene, the slice's pipeline exported for ``cuda`` (``torch.export``),
   written and loaded back (export seconds, artifact bytes), a session
   from ``session_from_checkpoints`` on checkpoints ``CheckpointManager``
   wrote of other seeded weights, behind a ``Server`` on a unix socket: a
   ``Client``'s batches of 8, 3 and 11 flagship scenes and two whole
   scenes, each answer bitwise the live kernel path's with the same noise
   and masks neither empty nor full; ``make_streamed_inference_fn`` over
   T=4 batches bitwise 4 eager calls and a second streamed run (which
   replays the first run's kept capture), and within the parity tolerances
   of the plain path, which launches nothing; with the counts set to 0
   just before, each session's and the first streamed run's capture
   launches every kernel of an eager request twice (its warm-up and the
   capture) and a replay none; a replayed request's device operations
   the exported program's eager call's plus its 3 input copies and 5
   output clones; host ms a request (median, min-max of ``REQUESTS``
   after a warm-up) of eager ``infer``, the exported program eagerly,
   ``InferenceSession.run`` (the replay), ``.predict``, a ``Client`` round
   trip and a streamed run over T, and the replay's and eager ``infer``'s
   device busy ms and idle share under ``torch.profiler``; after slice
   (A), an eager request's launches must equal each of (A)'s;
7. slice (K), evaluation (``run_eval_slice``), after slice (I), on (G)'s
   and (I)'s ``train_*`` checkpoints: ``run_eval.main`` at its defaults
   (16 scenes, B=4 x N=4096, ``--bootstrap 100``, npz dumps) launching
   exactly (A)'s kernels; at ``--score-thresh 0`` a second run (ScanNet
   dumps, read back) and ``--artifact`` (a cuda export at the eval's
   shape) with the live run's summary and dumps bit for bit; the paired
   ``--ab-fps-segments 1``, ``--ab-sa1-fps-segments 32`` and
   ``--ab-group-select strided`` arms on the flagship knobs (the JAX
   eval's summary keys; the sa1 arm one more ``fps`` launch a batch,
   ``mask_project_boxed`` and the strided groups launched); the eval
   loop's kernel path against its plain path batch by batch, in both arms
   of each of those configs and at the defaults, at the eval's mask
   threshold 0.5; and the eval's points/s, live and from the artifact
   (median and range of 5 runs of 64 scenes) and on the plain path;
8. slice (L), the knob paths (``run_knob_slice``), after slice (K):
   (L-bf16) ``set_pipeline_dtype(slice_config(), bfloat16)`` on (A)'s
   weights at both shapes, kernel path against its plain path as every
   slice, (A)'s launches a request, and against the float32 kernel path
   within ``tests/test_bf16.py``'s bounds (boxes rtol/atol 0.1, scores
   0.25), the share of mask cells that differ printed; (L-rgb)
   ``slice_config(feature_dim=3)`` on the flagship scenes with RGB, FP4's
   interp_mm launched with the 3-channel skip; an export and a CUDA-graph
   replay of each, bitwise the live kernel path; (L-object) ``train_gspn
   --preset object --synthetic-objects --num-points 4096``'s model and
   batch, 1 + 3 steps a path, (G)'s kernels once a step (the ball group
   at one radius with K = 4096), kernel path bitwise the plain path, then
   ``train_gspn.main`` with those flags for 3 steps; host ms a request of
   bf16 and float32 and a step of the object preset, and the device
   operations a bf16 and a float32 request makes; the kernel phase
   also times the ball group at (L-object)'s crop and interp_mm at FP4
   with the RGB skip;
9. slice (M), real-layout data (``run_data_slice``), after slice (L): from
   a seed, ``M_SCANS`` ScanNet scans of ``M_VERTICES`` vertices with RGB on
   an 8 x 8 m floor (binary PLY, ``segs.json``, ``aggregation.json`` with
   3-12 nyu40-labelled instances), a ShapeNet-style h5 (64 objects x 2048
   points, 2 categories) and a PartNet-style h5 (32 shapes x 10,000
   points), through an npz-backed stand-in for ``h5py.File`` where h5py is
   not installed; the scans preprocessed with ``python -m
   gspn_tpu_torch.data.preprocess_scannet`` and read back; host ms a
   ``ScanNetCrops`` batch (B=4 x N=4096) on the native and plain routes,
   with and without ``morton`` (median and range of 10); stage 1 at the
   default preset on the first ``--scannet-dir --morton`` batch (RGB,
   feature_dim 3), 1 + 3 steps a path, (G)'s kernels once a step, kernel
   path bitwise the plain path; with the counts set to 0 just before each:
   ``train_gspn --scannet-dir --morton`` 3 steps ((G)'s kernels a step),
   ``train_rpointnet --scannet-dir`` 3 steps on that checkpoint ((I)'s
   kernels), ``run_eval --scannet-dir --dump-format scannet`` on both
   ((K)'s kernels; the dumps named ``<scene>__crop<k>`` and read back),
   the eval loop's kernel path against its plain path batch by batch,
   ``train_gspn --preset object --shapenet-dir --shapenet-category 1
   --num-points 1024`` and ``train_gspn --partnet-dir`` 3 steps each and
   ``run_eval --partnet-dir`` at N=4096; the SA1 and crops' ball group and
   the box group, device ms on the same crops unsorted and Morton-sorted;
10. slice (N), data-parallel training (``run_dp_slice``), after slice (M):
   ``N_RANKS`` processes of this script (``--dp-rank WORK``) on the one
   card in a ``torch.distributed`` group (gloo, NCCL where each rank has a
   card), waited for with a time limit: in each, one DP step of stage 1
   (``train_config()``, (G)'s batch and noise) and of stage 2
   (``stage2_configs()`` without dropout or randomized RoIs, (I)'s draws)
   against the single-process step on the whole batch (loss within rtol
   1e-6, every tensor as ``_state_close`` holds it; the JAX package's
   elementwise bounds reported) and against its own plain path, bitwise,
   each rank the same state and exactly (G)'s and (I)'s point kernels a
   step (BatchNorm on cross-rank statistics launches no kernel of its own);
   host ms a DP step (Adam) there and in a one-rank group here;
   ``train_gspn --dp`` (3 steps) and ``train_rpointnet --dp`` (2 steps on
   that checkpoint), rank 0 alone writing;
11. slice (O), point sharding (``run_point_sharded_slice``), after slice
   (N): ``O_RANKS`` processes of this script (``--ps-rank WORK``) on the
   one card over gloo (correctness and plumbing, not scaling), each on a
   1-D mesh of every rank and a 2 x 2 one: (A)'s request through
   ``make_point_sharded_inference`` at the flagship (1-D and 2 x 2) and
   the whole scene (1-D), against its plain path (the parity rule) and
   the single-process ``infer`` on the same weights and noise (classes
   and validity equal, at most ``O_MASK_SHARE`` of the mask cells
   differing), each rank launching exactly a single-process request's
   kernels; one point-sharded step of stage 1 ((G)'s config, batch and
   noise) and of stage 2 ((I)'s without dropout or randomized RoIs: 80
   RoIs a scene) against the single-process step on the whole batch (loss
   within rtol 1e-5, every tensor as ``_state_close`` holds it) and
   bitwise against its own plain path, every rank the same state and
   (G)'s and (I)'s point kernels a step; ``train_gspn --point-sharded`` (3
   steps), ``train_rpointnet --point-sharded --data-rows 2`` (2 steps on
   that checkpoint) and ``run_eval --point-sharded`` (8 scenes, its
   predictions against a single-process eval's batch by batch), rank 0
   alone writing; host ms of the sharded requests and steps and, here,
   of the single-process ones;
12. slice (P), what the port took last (``run_complete_slice``), after
   slice (O): ``export_serving`` in two child processes that see no card
   (``CUDA_VISIBLE_DEVICES=""``), ``--platform cuda`` at B=8 x N=8192 and
   ``--platform cpu,cuda`` at B=2 x N=2048 (the CLI's default preset with
   (A)'s spatial segmented FPS, every proposal kept), and a third that
   exports (A)'s pipeline (``mask_thresh`` 0.49) with
   ``serve.export_inference``, while this process exports the same on the
   card (``--verify``): the third's outputs, bitwise its twin's and live
   ``infer``'s, hold masks neither empty nor full; each card-less program's
   graph equal to its twin's (``gspn::`` ops and every call in order); the
   card-less artifacts on the card through ``program.module()`` and
   ``InferenceSession``'s CUDA-graph replay, bitwise the twin's and live
   ``infer``'s with the CLI's seeded weights and ``chunk_noise(1, 0)``, (A)'s
   kernels a request (twice at the capture, none at a replay); the dual
   artifact's cpu program on the CPU, bitwise the live CPU pipeline;
   ``demo_predict`` at its defaults (both PLY files hold the scene's valid
   points, some painted; its scene, weights and noise through the plain model give the
   prediction PLY byte for byte); and the PointNet++ library modules at
   ``pointnet2_cls_msg.py``'s widths on B=16 x N=1024 objects (MSG SA1 and
   SA2, group-all SA3, an SSG SA1 with each pooling and one with knn
   grouping), kernel path against plain twins with the same weights,
   bitwise, ``fps`` and ``ball_group`` launched, the plain path none; then
   those two kernels at the MSG stack's shapes, bitwise their plain
   versions, with wrapper, device, plain and bound ms;
13. slice (Q), stage 2 with every option (``run_options_slice``), after
   slice (P): (I)'s configs, batch and frozen GSPN with ``roi_randomize``,
   ``head_dropout`` 0.3, ``remat``, non-default ``loss_weights`` and
   ``gt_box_jitter``, and ``share_fps=False``, 1 + 10 steps with every draw
   from a generator on the card seeded by the step, the launches counted;
   bitwise its plain path, the same without ``remat`` (the recompute's
   launches printed), and that with ``share_fps=True`` (exactly one
   ``fps`` launch a step fewer); ``train_rpointnet`` at its defaults with
   that model config, 4 steps against 2 + ``--resume`` 2, bitwise; one
   B=1 x N=65536 step with and without ``remat`` after a warm-up each,
   bitwise, ``torch.cuda.max_memory_allocated`` and host ms of each;
14. slice (R), the trainers' knobs (``run_train_knobs_slice``), after
   slice (Q), on (G)'s batch with (G)'s and (I)'s seeded weights and
   noise: (R-bf16) both stages in bfloat16 (``train_config()`` and
   ``stage2_configs()`` with ``dtype`` bfloat16, as ``--dtype bf16`` sets
   them), (R-strided) both with ``group_select="strided"`` (stage 2's
   frozen GSPN too) and (R-wide) both at ``--width-mult 2`` in float32,
   each 1 + 10 steps on its kernel path with exactly its launches a step
   ((G)'s and (I)'s; the strided groups in place of the first-K ones),
   bitwise its plain path (step 1's metrics and gradients, every loss,
   the parameters and running statistics); the bfloat16 gradients the
   gathers' backward sums and the bf16 losses beside float32's on the
   same weights; stage 2's FP plans at ``--width-mult 2`` (FP4, C 256, on
   the staged form) and the index_add launches of a step's backward with
   their channels; ``train_gspn`` and ``train_rpointnet --gspn-ckpt`` with
   ``--width-mult 2 --dtype bf16`` (3 steps; 4 against 2 + ``--resume`` 2,
   bitwise) and with ``--group-select strided`` (3 steps), each launching
   its stage's kernels; ``run_eval`` on the wide bf16 checkpoints at
   ``--score-thresh 0``, its loop's kernel path against its plain path
   batch by batch, and ``--artifact`` of ``export_serving``'s export of
   them at the eval's shape with the live summary bit for bit; the width
   study: host ms a step of each stage, float32 and bf16 at
   ``--width-mult`` 1, 2 and 4, and at 2 a ``torch.profiler`` window of
   each dtype (wall and busy ms, idle share, device operations a step);
   the kernel phase also times (R)'s launch shapes
   (``time_kernels.knob_launches``);
15. slice (S), the utils the port had left out (``run_roofline_slice``,
   ``run_sanitize_slice``), after slice (R): (S-roofline) each stage's
   floor under ``utils/roofline.py``'s model and the whole call timed
   with ``utils.timing.time_fn`` (median, min and max of
   ``ROOFLINE_CALLS``), its ``frac_of_roof`` and ``mfu`` against
   ``H100_SXM`` (``H100_SXM_BF16`` for bf16), for (A)'s config at both
   shapes, eager and through ``InferenceSession.run``, (L-bf16)'s
   flagship, a (G) step and an (I) step (``utils/profile_roofline.py``
   builds each call), with the launch counts set to 0 just before and
   read just after; and each kernel's model floor at its first shape
   beside its ``_bound`` (on slice (S)'s own lines, not in the kernels
   line; a ratio above 2 marked); (S-sanitize) ``python -m
   gspn_tpu_torch.utils.debug --sanitize`` (every launch of
   ``time_kernels.cases``, every forced plan of
   ``time_kernels.forced_plans``, a few small cases for the paths no
   slice takes; each bitwise its plain version) under
   ``compute-sanitizer`` with memcheck, racecheck, synccheck and initcheck
   at once, only the port's kernels checked; any report fails; where the
   machine has no ``compute-sanitizer``, or it answers "Device not
   supported" for a program that runs no kernel of the port (the card's
   machine), a line says so and the phase is left out; any other failure
   of that probe fails the run;
16. the ranking: for the flagship and the whole-scene request of slices
   (A), (B), (E) and (H), a pass of (F) at each shape and a step of (G),
   each kernel's (device ms - bound ms) summed over every launch of that
   request at its own shape (the launches must be the slice's, kernel for
   kernel), then the kernels no ranked request launches (the BatchNorm's
   four, at their layers' shapes), by slice; a JSON line of kernel
   results (``launches`` from the first slice that launches the kernel,
   named in ``slice``: (A) for the first-K path's, (B) for
   mask_project_boxed, (E) for the strided groups, (F) for the ball
   queries, (H) for fps_cluster, (G) for nn_argmin and index_add;
   ``launches_by_slice`` for each slice's own count, (M)'s and (N)'s their
   entry-point runs' and checked DP steps' summed, (O)'s its ranks'
   checked requests and steps summed, (P)'s its checked runs' summed, (R)'s
   every kernel-path run of the slice summed; ``device_events``, the
   profiler's events under ``device_ms``; ``ms_by_cluster_size`` for
   fps_cluster, ``ms_by_ctas`` for nn_argmin, ``ms_by_split`` for the ball
   and box groups,
   ``ms_by_plan`` for three_nn and interp_mm, ``device_ops_per_call`` for
   nms, index_add, interp_mm and nn_argmin), the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Any failure raises; no phase's error is caught. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gspn_tpu_torch.utils import time_kernels as tk
from gspn_tpu_torch.utils.bench_slice import STAGE2_PER_STEP as I_POINTS  # slice (I)
from gspn_tpu_torch.utils.roofline import H100_SXM

B, N = 8, 8192  # flagship request: 8 scenes x 8192 points
WS_N = 65536  # whole-scene request: 1 scene, last 10% of points padding
FLAGSHIP, WHOLE_SCENE = "B8xN8192", "B1xN65536"  # keys of bench_slice.SHAPES
REQUESTS = 20  # slice (A): timed requests per shape and path, after one warm-up
VARIANT_REQUESTS = 3  # slices (B)-(E)
TRAIN_STEPS = 10  # slice (G): timed training steps per path, after one warm-up
KERNEL_ITERS = 20  # timed launches per kernel and per plain version
PLAIN_SLOW_ITERS = 3  # timed calls of a plain version or library call slower than 20 ms
FIELDS = ("masks", "valid", "classes", "scores", "boxes")  # of InstancePredictions
PATH_KERNELS = {"fps", "ball_group", "box_group", "three_nn", "interp_mm", "nms"}
FPS_ROWS_N = 131072  # the cluster FPS's reach: twice the whole scene
NMS_ABOVE_OLD_CAP = 36864  # boxes a scene, beyond the NMS kernel's limit before 131,072
STRIDED = {"ball_group": "ball_group_strided", "box_group": "box_group_strided"}
# the kernel's symbols in the profiler's (demangled) device events; the
# template arguments of group_first_kernel and group_strided_kernel: the
# predicate (gspn::Ball<scales> or gspn::Box) and whether it writes
# coordinates (true: the ball and box groups; false: the ball queries)
DEVICE_SYMBOLS = {
    "fps": ("fps_kernel",), "fps_cluster": ("fps_cluster_kernel",),
    "ball_group": tk.BALL_SCANS["group_first_kernel", "true"],
    "ball_group_strided": tk.BALL_SCANS["group_strided_kernel", "true"],
    "box_group": ("group_first_kernel<gspn::Box",),
    "box_group_strided": ("group_strided_kernel<gspn::Box",),
    "ball_query": tk.BALL_SCANS["group_first_kernel", "false"],
    "ball_query_strided": tk.BALL_SCANS["group_strided_kernel", "false"],
    "three_nn": ("three_nn_kernel",), "interp_mm": ("interp_mm_kernel",),
    "mask_project": ("nearest_logit_kernel<false>",),
    "mask_project_boxed": ("nearest_logit_kernel<true>",), "nms": ("nms_kernel",),
    "nn_argmin": ("nn_argmin_kernel",), "index_add": ("index_add_kernel",),
    **tk.BN_SYMBOLS,
}


def bn_per_step(layers: int, recomputed: int = 0) -> dict:
    """The training BatchNorm's launches a step (``ops/batchnorm.py``): each
    training-mode ``MaskedBatchNorm`` layer launches ``bn_stats`` and
    ``bn_apply`` forward and ``bn_grad_terms`` and ``bn_grad_input``
    backward, once each; ``recomputed`` layers run forward again in
    remat's recompute. Cross-rank statistics ((N), (O)) run the module's
    own code and launch none."""
    return {"bn_stats": layers + recomputed, "bn_apply": layers + recomputed,
            "bn_grad_terms": layers, "bn_grad_input": layers}


# the trained BatchNorm layers: stage 1's center_enc, ctx_enc_0-2 and
# recog_enc (3 each; the object preset has one context encoder); stage 2's
# SA1-SA4 (3 each), FP1-FP4 (2, 2, 2, 3), roi_mlp and mask_mlp (2 each)
G_BN, OBJECT_BN, I_BN, I_REMAT_BN = 15, 9, 25, 21
# slice (G)'s point kernels a step: nn_argmin gives the chamfer's argmins
# both ways in one launch; index_add is the chamfer's gather backward into
# the generated points
G_POINTS = {"fps": 1, "ball_group": 1, "nn_argmin": 1, "index_add": 1}
G_PER_STEP = {**G_POINTS, **bn_per_step(G_BN)}
OBJECT_PER_STEP = {**G_POINTS, **bn_per_step(OBJECT_BN)}  # train_gspn --preset object
I_PER_STEP = {**I_POINTS, **bn_per_step(I_BN)}
# slice (Q) launches a step: (I)'s, but fps for the seeds and SA1 apart
# (share_fps=False), no box_group (randomized RoIs are a Gumbel top-k), and
# remat's recompute of SA1-SA4 (fps, ball_group) and FP1-FP4 (three_nn,
# interp_mm, and their BatchNorms' forward) in backward
Q_PER_STEP = {"fps": 9, "ball_group": 9, "three_nn": 8, "interp_mm": 8, "index_add": 8,
              **bn_per_step(I_BN, I_REMAT_BN)}
SLICE_KERNELS = {  # what each slice's kernel path launches; the others stay at 0
    "A": PATH_KERNELS | {"mask_project"},
    "B": PATH_KERNELS | {"mask_project_boxed"},
    "C": PATH_KERNELS - {"box_group"} | {"mask_project"},
    "D": PATH_KERNELS,
    "E": {STRIDED.get(k, k) for k in PATH_KERNELS} | {"mask_project"},
    "F": {"fps", "ball_query", "ball_query_strided"},
    "H": PATH_KERNELS | {"mask_project", "fps_cluster"},
    "G": set(G_PER_STEP),
    "I": set(I_PER_STEP),
    "K": PATH_KERNELS | {"mask_project"},
    "L-bf16": PATH_KERNELS | {"mask_project"},
    "L-rgb": PATH_KERNELS | {"mask_project"},
    "L-object": set(G_PER_STEP),
    "P": PATH_KERNELS | {"mask_project"},
    "Q": set(Q_PER_STEP),
    # (I)'s, strided too, (G)'s argmin, and the eval's (K)
    "R": set(I_PER_STEP) | set(STRIDED.values()) | {"nn_argmin", "mask_project", "nms"},
}
# slice (R): the trainers' --dtype bf16, --group-select strided and
# --width-mult knobs at full width; the width study's multipliers and its
# profiler windows' steps
R_WIDTHS, R_WINDOW_STEPS = (1, 2, 4), 3
# launches a strided step: the strided groups in place of the first-K ones
# (stage 2's frozen GSPN strided too, as train_rpointnet's _stage_knobs sets it)
R_STRIDED_G = {STRIDED.get(k, k): c for k, c in G_PER_STEP.items()}
R_STRIDED_I = {STRIDED.get(k, k): c for k, c in I_PER_STEP.items()}
# slice (L): the knob paths' RGB width, and train_gspn --preset object's
# point count (one crop of K = OBJECT_N points) and timed steps per path
FDIM, OBJECT_N, OBJECT_STEPS = 3, 4096, 3
# the card's peaks (utils/roofline.py H100_SXM, NVIDIA's data sheet): HBM3
# bytes/s, and float32 operations outside the tensor cores, one a lane and
# clock (132 SMs x 128 lanes x 1.98 GHz; the published 67 TFLOP/s counts an
# FMA as two, and the kernels build with -fmad=false, so none of their
# adds, multiplies and compares is fused)
HBM_BYTES_PER_S, F32_OPS_PER_S = H100_SXM.hbm_bytes, H100_SXM.vpu_ops
# slice (S-roofline): timed calls of each case after a warm-up; a kernel
# whose model floor and _bound differ by more than this factor is marked
ROOFLINE_CALLS, ROOFLINE_GAP = 10, 2.0
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


def _host_ms(fn) -> tuple[float, object]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _first(out):
    """A kernel's first output where it returns several (three_nn: dist)."""
    return out[0] if isinstance(out, tuple) else out


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
    """Phase 3. Returns ``(the JSON entries, {request: [(kernel, case
    label)]}, {kernel: floors})``: each kernel's times at its first shape,
    every launch of the ranked slices' requests
    (``time_kernels.ranked_keys``), and each kernel's floors at its first
    shape under the roofline model's per-op cost
    (``profile_roofline.kernel_cost``), which slice (S) prints."""
    from gspn_tpu_torch.data import synthetic
    from gspn_tpu_torch.models.rpointnet import roi_grid_points
    from gspn_tpu_torch.ops import fps as tfps
    from gspn_tpu_torch.ops.mask_project import (
        ROI_BLOCK_BOXED, TILE_N_BOXED, boxed_layout, tile_relevance,
    )
    from gspn_tpu_torch.utils import profile_roofline

    # the main path's inputs (time_kernels.main_path_inputs): scenes, their
    # sorted views, seeds, SA centres, boxes about the seeds, RoI samples
    _phase("kernels")
    inputs = tk.main_path_inputs(ops, bench_slice, dev)
    main_path = tk.cases(ops, bench_slice, dev, inputs)
    requests = {key: [] for key in tk.ranked_keys()}
    for name, items in main_path.items():
        for label, _, reqs in items:
            for req in reqs:
                requests[req].append((name, label))
    fl, wsi = inputs[FLAGSHIP], inputs[WHOLE_SCENE]
    xyz, valid, sa1, boxes, roi_xyz = (
        fl["xyz"], fl["valid"], fl["sa"][0], fl["boxes"], fl["roi_xyz"])
    ws, wsv, ws_boxes = wsi["xyz"], wsi["valid"], wsi["boxes"]
    gen = torch.Generator().manual_seed(0)
    grid = roi_grid_points(boxes, 64)[0].reshape(B, 64 * 64, 3)
    ws_grid = roi_grid_points(ws_boxes, 64)[0].reshape(1, 64 * 64, 3)
    targets = xyz[:, None].expand(B, 64, N, 3).reshape(B * 64, N, 3)
    # FP4's and FP1's interpolation at the flagship: sources, indices,
    # distances, skip rows; the weights the distances give
    fp4, fp1 = main_path["interp_mm"][0][1], main_path["interp_mm"][1][1]
    fp4_w, fp1_w = (ops.three_interpolate_weights(a[2]) for a in (fp4, fp1))
    pred, gt, _, gt_valid = main_path["nn_argmin"][0][1]  # the chamfer's both ways
    chain_boxes, chain_scores = _chain_nms_case(dev, B, 64, 32, gen)
    nms2k, nms4k = _chain_nms_case(dev, 1, 2048, 128, gen), _chain_nms_case(dev, 1, 4096, 128, gen)
    nms1k = _chain_nms_case(dev, 1, 1024, 128, gen)
    nms36k = _chain_nms_case(dev, 1, NMS_ABOVE_OLD_CAP, 128, gen)
    tie_src = torch.rand((16, 2048, 3), generator=gen) * 4
    tie_src = torch.cat([tie_src, tie_src], dim=1).to(dev)  # source j + 2048 repeats j
    tie_tgt = (torch.rand((16, 4096, 3), generator=gen) * 4).to(dev)
    tie_valid = (torch.rand((16, 4096), generator=gen) > 0.2).to(dev)
    tie_valid1 = (torch.rand((16, 4096), generator=gen) > 0.2).to(dev)
    # exact FPS beyond one block: 4 x 16384 training scenes; 2 x 14273 with
    # an all-invalid row; one row of FPS_ROWS_N points, 10 % padding
    t16 = bench_slice.train_batch(dev, n=16384)
    odd = ops.gather_point(ws, torch.arange(2 * 14273, device=dev)[None] % WS_N).reshape(
        2, 14273, 3)
    odd_valid = torch.ones((2, 14273), dtype=torch.bool, device=dev)
    odd_valid[0, -1427:] = False
    odd_valid[1] = False
    big = torch.from_numpy(synthetic.scene_batch(
        np.random.default_rng(0), 1, n_points=FPS_ROWS_N, max_instances=24, extent=8.0)["xyz"]
    ).to(dev)
    big_valid = torch.ones((1, FPS_ROWS_N), dtype=torch.bool, device=dev)
    big_valid[:, -FPS_ROWS_N // 10:] = False
    # (L)'s launch shapes: the object preset's crop (one radius of 2.0, K =
    # OBJECT_N, about 64 seeds of 4 objects) and FP4 with the RGB skip
    objs = synthetic.object_scene_batch(np.random.default_rng(0), 4, OBJECT_N)
    obj_xyz, obj_valid = (torch.from_numpy(objs[k]).to(dev) for k in ("xyz", "valid"))
    obj_q = ops.gather_point(obj_xyz, ops.farthest_point_sample(64, obj_xyz, obj_valid))
    fp4_rgb = (*main_path["interp_mm"][0][1][:3], torch.rand((B, N, FDIM), generator=gen).to(dev))

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
            return _nbytes(pts, pvalid, q, *tk.flatten(out)), tested * (8 + nscales)
        return work

    def box_work(pts, pvalid, bx, strided):  # a point test: six compares
        n = pts.shape[1]

        def work(out):
            tested = bx.shape[0] * bx.shape[1] * n if strided else _first_k_tested([out], n)
            return _nbytes(pts, pvalid, bx, *out), tested * 6
        return work

    def nn_work(tgt, src, svld=None):  # a pair: the distance and a compare
        return lambda out: (_nbytes(tgt, src, svld, *tk.flatten(out)),
                            tgt.shape[0] * tgt.shape[1] * src.shape[1] * 9)

    def pair_work(tgt, src, tvld, svld):  # a pair: the distance and a compare each way
        return lambda out: (_nbytes(tgt, src, tvld, svld, *out),
                            tgt.shape[0] * tgt.shape[1] * src.shape[1] * 10)

    def mm_work(args):
        """An interpolated channel: three multiplies, two adds; from the
        distances, a row's weights too (three compares, three divisions,
        two adds, three divisions); the skip rows are read and written."""
        pts, idx = args[:2]
        rows = idx.shape[0] * idx.shape[1]
        weights = 11 * rows if len(args) == 4 else 0
        return lambda out: (_nbytes(*args, out), rows * pts.shape[2] * 5 + weights)

    def proj_work(pts, samp, lg, share=1.0, *extra):  # a (point, sample) pair
        b, r, s_, _ = samp.shape
        return lambda out: (_nbytes(pts, samp, lg, *extra, out),
                            b * r * s_ * pts.shape[1] * 9 * share)

    def nms_work(bx, sc):  # a pair: IoU (~19 operations) and the compare
        return lambda out: (_nbytes(bx, sc, out), bx.shape[0] * bx.shape[1] ** 2 * 20)

    def add_work(src, idx):  # an add a source element
        return lambda out: (_nbytes(src, idx, out), src.numel())

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

    def boxed_work(pts, samp, lg, bx, _, pvalid):  # the relevant tiles' pairs
        tn, npad, rb, rpad = boxed_layout(pts.shape[1], bx.shape[1], ROI_BLOCK_BOXED,
                                          TILE_N_BOXED)
        share = tile_relevance(pts, pvalid, bx, tn, npad, rb, rpad).float().mean().item()
        print(f"mask_project_boxed: relevant (RoI block, tile) share {share:.4f} at "
              f"{pts.shape[0]} x {pts.shape[1]} points")
        return proj_work(pts, samp, lg, share, bx, pvalid)

    main_work = {  # kernel -> work(a ranked case's args)
        "fps": lambda a: fps_work(a[1], a[2], a[0]),
        "fps_cluster": lambda a: fps_work(a[1], a[2], a[0]),
        "ball_group": lambda a: ball_work(a[2], a[4], a[3], len(a[0]), False),
        "ball_group_strided": lambda a: ball_work(a[2], a[4], a[3], len(a[0]), True),
        "ball_query": lambda a: ball_work(a[2], a[4], a[3], len(a[0]), False),
        "ball_query_strided": lambda a: ball_work(a[2], a[4], a[3], len(a[0]), True),
        "box_group": lambda a: box_work(a[2], a[3], a[0], False),
        "box_group_strided": lambda a: box_work(a[2], a[3], a[0], True),
        "nms": lambda a: nms_work(a[0], a[1]),
        "three_nn": lambda a: nn_work(*a), "interp_mm": mm_work,
        "mask_project": lambda a: proj_work(*a), "mask_project_boxed": lambda a: boxed_work(*a),
        "nn_argmin": lambda a: pair_work(*a), "index_add": lambda a: add_work(*a[:2]),
    }

    def main_cases(name):  # every ranked launch of the kernel (time_kernels.cases)
        return [(label, lambda impl, a=a: tk.call(ops, name, a, impl), main_work[name](a))
                for label, a, _ in main_path[name]]

    def first_label(name, i=0):
        return main_path[name][i][0]

    def swept(name):  # the cases the plan sweeps take: all but (I)'s step
        return [c for c in main_path[name]
                if not (c[2] and all(r.startswith("(I) ") for r in c[2]))]

    grid_label = f"grid RoIAlign: {B}x4096 targets <- {N}"
    nn_extra = [  # three_nn off the main path: (D)'s masks, (C)'s grid RoIs
        (f"3nn masks: {B * 64}x{N} targets <- 64", (targets, roi_xyz.reshape(B * 64, 64, 3), None)),
        (grid_label, (grid, xyz, valid)),
        (f"grid RoIAlign, whole scene: 1x4096 targets <- {WS_N}", (ws_grid, ws, wsv)),
    ]
    cases = {  # name -> [(shape label, fn(impl), work)], main shape first
        "fps": main_cases("fps"),
        "fps_cluster": main_cases("fps_cluster") + [
            ("exact, train_gspn --num-points 16384: 4 x 16384 pts, 64 picks",
             lambda impl: ops.farthest_point_sample(64, t16["xyz"], t16["valid"], impl=impl),
             fps_work(t16["xyz"], t16["valid"], 64)),
            ("2 x 14273 pts (one row all invalid), 256 picks",
             lambda impl: ops.farthest_point_sample(256, odd, odd_valid, impl=impl),
             fps_work(odd, odd_valid, 256)),
            (f"1 x {FPS_ROWS_N} pts (10 % padding), 256 picks",
             lambda impl: ops.farthest_point_sample(256, big, big_valid, impl=impl),
             fps_work(big, big_valid, 256)),
        ],
        "ball_group": main_cases("ball_group") + [
            (f"object preset crops (L-object): 4 x 64 seeds, r 2.0, K = {OBJECT_N} <- "
             f"{OBJECT_N} pts",
             lambda impl: ops.query_ball_group_multi((2.0,), (OBJECT_N,), obj_xyz, obj_q,
                                                     obj_valid, impl=impl),
             ball_work(obj_xyz, obj_valid, obj_q, 1, False))],
        "ball_group_strided": main_cases("ball_group_strided"),
        "box_group": main_cases("box_group"),
        "box_group_strided": main_cases("box_group_strided"),
        "ball_query": main_cases("ball_query"),
        "ball_query_strided": main_cases("ball_query_strided"),
        "three_nn": main_cases("three_nn") + [
            (label, lambda impl, a=a: ops.three_nn(*a, impl=impl), nn_work(*a))
            for label, a in nn_extra],
        # the FP levels from the distances (FP1-FP3 with their skip rows),
        # then the form that takes weights (three_interpolate_mm)
        "interp_mm": main_cases("interp_mm") + [
            (f"FP4 with the RGB skip (L-rgb): {B}x{N} targets <- 1024 x "
             f"{fp4_rgb[0].shape[-1]}, C1 = {FDIM}, direct",
             lambda impl: ops.three_interpolate_fp(*fp4_rgb, impl=impl), mm_work(fp4_rgb))] + [
            (f"weights form: {label}", lambda impl, a=a, w=w: ops.three_interpolate_mm(
                a[0], a[1], w, impl=impl), mm_work((a[0], a[1], w)))
            for label, a, w in ((first_label("interp_mm", 0), fp4, fp4_w),
                                (first_label("interp_mm", 1).split(" + ")[0], fp1, fp1_w))],
        "mask_project": main_cases("mask_project"),
        "mask_project_boxed": main_cases("mask_project_boxed"),
        # both ways (nn_argmin_pair), then one way (nn_argmin)
        "nn_argmin": main_cases("nn_argmin") + [
            ("16 rows x 4096 <-> 4096 both ways, each source twice (ties), masked both ways",
             lambda impl: ops.nn_argmin_pair(tie_tgt, tie_src, tie_valid1, tie_valid, impl=impl),
             pair_work(tie_tgt, tie_src, tie_valid1, tie_valid)),
            ("one way: chamfer pred -> GT, 256 rows x 256 <- 256, GT masked",
             lambda impl: ops.nn_argmin(pred, gt, gt_valid, impl=impl),
             nn_work(pred, gt, gt_valid)),
            ("one way: 16 rows x 4096 <- 4096, each source twice (ties), masked",
             lambda impl: ops.nn_argmin(tie_tgt, tie_src, tie_valid, impl=impl),
             nn_work(tie_tgt, tie_src, tie_valid)),
        ],
        "nms": main_cases("nms") + [
            (f"{B}x64 boxes with a suppression chain 32 deep",
             lambda impl: ops.nms_3d_batched(chain_boxes, chain_scores, 0.25, impl=impl),
             nms_work(chain_boxes, chain_scores)),
            ("1x1024 boxes with a suppression chain 128 deep (ranked in the kernel)",
             lambda impl: ops.nms_3d_batched(*nms1k, 0.25, impl=impl), nms_work(*nms1k)),
            ("1x2048 boxes with a suppression chain 128 deep",
             lambda impl: ops.nms_3d_batched(*nms2k, 0.25, impl=impl), nms_work(*nms2k)),
            ("1x4096 boxes with a suppression chain 128 deep",
             lambda impl: ops.nms_3d_batched(*nms4k, 0.25, impl=impl), nms_work(*nms4k)),
            (f"1x{NMS_ABOVE_OLD_CAP} boxes with a suppression chain 128 deep (above the "
             "32,768 the kernel took before its suppressed bits moved to dynamic shared memory)",
             lambda impl: ops.nms_3d_batched(*nms36k, 0.25, impl=impl), nms_work(*nms36k)),
        ],
        "index_add": main_cases("index_add"),
    }
    # the training BatchNorm's kernels at the training cells' layer shapes
    # (time_kernels.bn_cases), each against what the kernel itself reads
    # and writes: the column sums around it are PyTorch's reductions, in
    # the wrapper's ms and not in the kernel's device ms
    bn = tk.bn_cases(ops, dev)

    def bn_work(name, a):
        x = a[0]
        if name == "bn_stats":  # the sums s1, s2 (and the weights' total) in, the stats out
            c = x.shape[1]
            return lambda out: (_nbytes(out) + 4 * (2 * c + (a[1] is not None)), 10 * c)
        # an element: apply's subtract, two multiplies, add and ReLU; the
        # terms' recomputed output, its ReLU test and four products; dx's
        # two adds of the square term, the mean term's add and, masked, two
        # multiplies by the weight
        per = {"bn_apply": 5, "bn_grad_terms": 10,
               "bn_grad_input": 4 if a[2] is None else 6}[name]
        return lambda out: (_nbytes(*a, *tk.flatten(out)), x.numel() * per)

    for name, items in bn.items():
        cases[name] = [(label, lambda impl, a=a, kw=kw, name=name: tk.bn_call(ops, name, a, kw,
                                                                               impl),
                        bn_work(name, a)) for label, a, kw in items]

    def cdist_pair(tgt, src, svalid, mode):
        """One ``torch.cdist`` (``mode``: explicit differences, or the
        matmul expansion ``|a|^2 - 2ab + |b|^2``) and its two argmins: each
        source's nearest target, and each target's nearest valid source
        (invalid sources set to +inf): the nearest by distance, not
        squared."""
        def call():
            d = torch.cdist(tgt, src, compute_mode=mode)
            cols = d.argmin(-2)
            return d.masked_fill(~svalid[:, None, :], float("inf")).argmin(-1), cols
        return call

    def embedding_bag_interp(pts, idx, w):
        """One ``F.embedding_bag`` (mode "sum", ``per_sample_weights``) over
        the flattened batch: each target row a bag of its three source rows
        (the batch offsets are added here, untimed)."""
        b, n, _ = idx.shape
        m, c = pts.shape[1:]
        flat = (idx.long() + (torch.arange(b, device=dev) * m)[:, None, None]).reshape(b * n, 3)
        table, weights = pts.reshape(b * m, c), w.reshape(b * n, 3)
        return lambda: torch.nn.functional.embedding_bag(
            flat, table, mode="sum", per_sample_weights=weights).reshape(b, n, c)

    def max_abs_diff(got, want):
        return (got - want).abs().max().item()

    def max_rel_diff(got, want):
        """Max |got - want| over the largest |want|: sums of many terms in
        another order differ by rounding that grows with the sum."""
        return max_abs_diff(got, want) / want.abs().max().item()

    def sqdist_gap(tgt, src):
        """Max gap between the squared distances of the library's and the
        kernel's picks: the square root can merge near-ties (and the matmul
        expansion round them apart), so the indices may differ where the
        distances do not."""
        def gap(got, want):
            d = [(tgt - ops.gather_point(src, i)).square().sum(-1) for i in (got, want)]
            return max_abs_diff(*d)
        return gap

    def pair_gap(tgt, src):
        """``sqdist_gap`` each way."""
        rows, cols = sqdist_gap(tgt, src), sqdist_gap(src, tgt)
        return lambda got, want: max(rows(got[0], want[0]), cols(got[1], want[1]))

    def cdist_topk(tgt, src, svalid=None):
        """One ``torch.cdist`` (explicit differences) and its ``topk(3)``:
        three_nn's function, distances not squared; invalid sources are
        set to +inf first."""
        def call():
            d = torch.cdist(tgt, src, compute_mode="donot_use_mm_for_euclid_dist")
            if svalid is not None:
                d = d.masked_fill(~svalid[:, None, :], float("inf"))
            return d.topk(3, largest=False)
        return call

    def topk_gap(got, want):
        """Max gap between the kernel's squared distances and the squares
        of the library's (the square root can merge near-ties)."""
        return max_abs_diff(got.values.square(), _first(want))

    def cdist_project(pts, samp, lg):
        """One ``torch.cdist`` over every (RoI, point, sample) triple and its
        ``argmin``, then the nearest sample's logit: the dense 1-NN
        projection (the points are repeated per RoI here, untimed)."""
        b, r, s_, _ = samp.shape
        rep = pts[:, None].expand(b, r, *pts.shape[1:]).reshape(b * r, pts.shape[1], 3)
        flat_s, flat_l = samp.reshape(b * r, s_, 3), lg.reshape(b * r, s_)

        def call():
            near = torch.cdist(rep, flat_s,
                               compute_mode="donot_use_mm_for_euclid_dist").argmin(-1)
            return torch.gather(flat_l, 1, near).reshape(b, r, -1), near
        return call

    def project_gap(pts, samp):
        """Max gap between the squared distance to the library's nearest
        sample and the least one (the square root can merge near-ties, and
        then the logits differ where the distances do not)."""
        b, r, s_, _ = samp.shape
        rep = pts[:, None].expand(b, r, *pts.shape[1:]).reshape(b * r, pts.shape[1], 3)

        def gap(got, want):
            d2 = ops.pairwise_sqdist(rep, samp.reshape(b * r, s_, 3))
            picked = torch.gather(d2, -1, got[1][..., None])[..., 0]
            return max_abs_diff(picked, d2.min(-1).values)
        return gap

    def index_add_library(src, idx, n_out):
        """One ``index_add_`` over the batch-offset rows (the library's
        order of adds is not fixed)."""
        b, m, c = src.shape
        flat = (idx.long() + (torch.arange(b, device=src.device) * n_out)[:, None]).reshape(-1)
        rows = src.reshape(b * m, c)
        return lambda: torch.zeros((b * n_out, c), device=src.device).index_add_(
            0, flat, rows).reshape(b, n_out, c)

    # name -> [(case label, the library call's name, one PyTorch call on
    # that case's inputs, its gap to the kernel's output, the largest gap
    # allowed)]; the first is the kernel's library_ms. The matmul expansion
    # loses ~1e-6 of |a|^2 + |b|^2 (scene coordinates up to a few metres)
    # to cancellation, so its picks may be 1e-3 apart in squared distance
    first = {name: main_path[name][0][0] for name in main_path}
    library = {
        "interp_mm": [(first["interp_mm"], "torch.sparse.mm", sparse_interp(
            (fp4[0], fp4[1], fp4_w)), max_abs_diff, 1e-4),
                      (first["interp_mm"], "F.embedding_bag", embedding_bag_interp(
                          fp4[0], fp4[1], fp4_w), max_abs_diff, 1e-4)],
        "nn_argmin": [(first["nn_argmin"], "torch.cdist, explicit differences", cdist_pair(
            pred, gt, gt_valid, "donot_use_mm_for_euclid_dist"), pair_gap(pred, gt), 1e-6),
                      (first["nn_argmin"], "torch.cdist, matmul expansion", cdist_pair(
                          pred, gt, gt_valid, "use_mm_for_euclid_dist"), pair_gap(pred, gt),
                       1e-3)],
        "three_nn": [(first["three_nn"], "torch.cdist + topk", cdist_topk(xyz, sa1), topk_gap,
                      1e-5),
                     (grid_label, "torch.cdist + topk", cdist_topk(grid, xyz, valid), topk_gap,
                      1e-5)],
        "mask_project": [(first["mask_project"], "torch.cdist + argmin + gather",
                          cdist_project(xyz, roi_xyz, fl["logits"]),
                          project_gap(xyz, roi_xyz), 1e-6)],
        # the dense projection's function, at the sorted shape
        "mask_project_boxed": [(first["mask_project_boxed"], "torch.cdist + argmin + gather",
                                cdist_project(fl["sxyz"], roi_xyz, fl["logits"]),
                                project_gap(fl["sxyz"], roi_xyz), 1e-6)],
        "index_add": [(first["index_add"], "index_add_",
                       index_add_library(*main_path["index_add"][0][1]), max_rel_diff, 1e-5)],
    }

    def bn_forward_library(x, stats, scale, bias):
        """One ``F.batch_norm`` in training mode (its own statistics) and the
        ReLU: the layer's forward as the library takes it, unweighted."""
        return lambda: torch.relu(torch.nn.functional.batch_norm(
            x, None, None, scale, bias, True, 0.0, tk.BN_EPS))

    def bn_backward_library(x, g, stats, scale, bias):
        """One ``aten.native_batch_norm_backward`` of the ReLU's gradient (made
        here, untimed) given the batch's mean and rstd: the layer's backward
        as the library takes it (dx, and the scale's and bias' gradients)."""
        c = x.shape[1]
        gy = ops.batch_norm_grad_terms(x, g, stats, scale, bias, relu=True, impl="plain")[0]
        return lambda: torch.ops.aten.native_batch_norm_backward(
            gy, x, scale, None, None, stats[:c], stats[c:2 * c], True, tk.BN_EPS,
            [True, True, True])

    # the unweighted shapes (F.batch_norm takes no row weights); sums in
    # another order: about 1e-6 of the largest output apart on the CPU
    for (label, a, _), (_, ta, _) in zip(bn["bn_apply"], bn["bn_grad_terms"], strict=True):
        if "masked" in label:
            continue
        library.setdefault("bn_apply", []).append(
            (label, "F.batch_norm + ReLU (training)", bn_forward_library(*a), max_rel_diff,
             1e-4))
        library.setdefault("bn_grad_input", []).append(
            (label, "aten.native_batch_norm_backward", bn_backward_library(*ta),
             lambda got, want: max_rel_diff(got[0], want), 1e-4))
    entries, model_floors = [], {}
    for name, shapes in cases.items():
        k = ops.KERNELS[name]
        main = None
        by_shape = {"device_ms_by_shape": {}, "bound_ms_by_shape": {}}
        for label, fn, work in shapes:
            first_ms, want = _host_ms(lambda fn=fn: fn("plain"))
            err = tk.max_abs_err(tk.flatten(fn("cuda")), tk.flatten(want))
            ms = tk.cuda_ms(lambda fn=fn: fn("cuda"), KERNEL_ITERS)
            # a plain version of ~1000 dependent small launches (exact FPS at
            # the whole scene) is timed over fewer calls
            plain_ms = tk.cuda_ms(lambda fn=fn: fn("plain"),
                                  KERNEL_ITERS if first_ms < 20 else PLAIN_SLOW_ITERS)
            dev_ms, events = tk.device_ms(lambda fn=fn: fn("cuda"), KERNEL_ITERS,
                                          DEVICE_SYMBOLS[name])
            bound_ms, bound_by = _bound(*work(want))
            dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
            print(f"kernel {name} [{label}]: equal to plain (max abs err {err}); "
                  f"wrapper {ms:.4f} ms (kernel's device time {dev_txt} over "
                  f"{events} of {KERNEL_ITERS} launches), "
                  f"plain {plain_ms:.4f} ms; bound {bound_ms:.5f} ms ({bound_by})")
            by_shape["device_ms_by_shape"][label] = dev_ms
            by_shape["bound_ms_by_shape"][label] = bound_ms
            if main is None:
                main = (err, ms, plain_ms, dev_ms, events, bound_ms, bound_by)
        library_ms = {}
        fns = {label: fn for label, fn, _ in shapes}
        for label, lib_name, lib_fn, lib_gap, lib_tol in library.get(name, ()):
            first_ms, lib_out = _host_ms(lib_fn)
            lib_err = lib_gap(lib_out, fns[label]("cuda"))
            if lib_err > lib_tol:
                raise AssertionError(f"{name}: {lib_name} differs by {lib_err}")
            del lib_out
            key = f"{label}: {lib_name}"
            library_ms[key] = tk.cuda_ms(
                lib_fn, KERNEL_ITERS if first_ms < 20 else PLAIN_SLOW_ITERS)
            print(f"kernel {name} [{label}]: library call {lib_name} "
                  f"{library_ms[key]:.4f} ms (max abs diff {lib_err:.2e})")
        if name in main_path:  # the roofline model prices no BatchNorm kernel
            model_floors[name] = profile_roofline.kernel_cost(name, main_path[name][0][1]).floors()
        entries.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": "; ".join(r.split()[0] for r in k.replaces.split("; ")),
            "launches": 0, "max_abs_err": main[0], "ms": main[1], "plain_ms": main[2],
            "device_ms": main[3], "device_events": main[4], "bound_ms": main[5],
            "bound_by": main[6],
            "library_ms": next(iter(library_ms.values()), None),
            **({"library_ms_by_shape": library_ms} if library_ms else {}), **by_shape,
        })

    # the cluster FPS at every cluster size that holds the row, kernel only
    # (bitwise the plain version each time); fps_cluster_size's pick marked
    sweep = {}
    for label, pts, pvalid, npoint in (
            (f"1 x {WS_N}, 1024 picks", ws, wsv, 1024),
            ("4 x 16384, 64 picks", t16["xyz"], t16["valid"], 64),
            ("2 x 14273, 256 picks", odd, odd_valid, 256),
            (f"1 x {FPS_ROWS_N}, 256 picks", big, big_valid, 256)):
        want = ops.farthest_point_sample(npoint, pts, pvalid, impl="plain")
        times = {}
        for cs, run in tk.forced_plans("fps_cluster", (npoint, pts, pvalid)).items():
            tk.max_abs_err([run()], [want])
            times[cs] = tk.cuda_ms(run, KERNEL_ITERS)
        sweep[label] = times
        pick = tfps.fps_cluster_size(pts.shape[1])
        print(f"fps_cluster sweep [{label}]: ms by cluster size (CUDA events, bitwise the plain "
              f"version at each) " + ", ".join(f"{cs}: {ms:.4f}{' (picked)' * (cs == pick)}"
                                                for cs, ms in times.items()))
    next(e for e in entries if e["name"] == "fps_cluster")["ms_by_cluster_size"] = sweep

    # the ball and box groups, first-K and strided, at every split (warps a
    # query; and the strided groups' direct mode, "direct") and every ranked
    # shape, kernel only (bitwise the plain version each time), device ms:
    # the wrapper's host work (~0.1 ms) would hide the kernel; the strided
    # groups' pick (ops.ball_query.strided_split) marked
    from gspn_tpu_torch.ops import ball_query as tquery

    for name in ("ball_group", "box_group", "ball_group_strided", "box_group_strided"):
        splits = {}
        strided = name in STRIDED.values()
        for label, args, _ in swept(name):
            want = tk.flatten(tk.call(ops, name, args, "plain"))
            pts, q = args[2], (args[3] if name.startswith("ball") else args[0])
            pick = None
            if strided:
                split, direct = tquery.strided_split(q.shape[0] * q.shape[1], pts.shape[1])
                pick = "direct" if direct else split
            times = {}
            for split, run in tk.forced_plans(name, args).items():
                tk.max_abs_err(tk.flatten(run()), want)
                times[split] = tk.device_ms(run, KERNEL_ITERS, DEVICE_SYMBOLS[name])[0]
            splits[label] = times
            print(f"{name} split sweep [{label}]: device ms by warps a query (bitwise the "
                  f"plain version at each) " + ", ".join(
                      f"{sp}: {ms}{' (picked)' * (sp == pick)}" for sp, ms in times.items()))
        next(e for e in entries if e["name"] == name)["ms_by_split"] = splits

    # three_nn at every (targets a thread, source slices, group) at each of
    # its shapes, kernel only (bitwise the plain version each time), device
    # ms; three_nn_plan's pick marked
    from gspn_tpu_torch.ops import interpolate as tinterp

    plans = {}
    for label, args in [(label, a) for label, a, _ in swept("three_nn")] + nn_extra:
        want = tk.flatten(ops.three_nn(*args, impl="plain"))
        pick = "x".join(map(str, tinterp.three_nn_plan(args[0].shape[0], args[0].shape[1],
                                                       args[1].shape[1])))
        times = {}
        for plan, run in tk.forced_plans("three_nn", args).items():
            tk.max_abs_err(tk.flatten(run()), want)
            times[plan] = tk.device_ms(run, KERNEL_ITERS, DEVICE_SYMBOLS["three_nn"])[0]
        plans[label] = times
        print(f"three_nn plan sweep [{label}]: device ms by targets a thread x source slices "
              "x sources a group (bitwise the plain version at each) " + ", ".join(
                  f"{plan}: {ms}{' (picked)' * (plan == pick)}" for plan, ms in times.items()))
    next(e for e in entries if e["name"] == "three_nn")["ms_by_plan"] = plans

    # the FP interpolation at every (rows, slices, stage) at each ranked
    # shape (direct: rows a task x slices; staged, where the shape allows
    # it: rows a chunk x slices of 32 channels), kernel only (bitwise
    # the plain version each time), device ms; interp_mm_plan's pick marked
    plans = {}
    for label, args, _ in swept("interp_mm"):
        pts, idx, _, skip = args
        want = tk.flatten(ops.three_interpolate_fp(*args, impl="plain"))
        pick = "x".join(map(str, tinterp.interp_mm_plan(
            idx.shape[0], idx.shape[1], pts.shape[1], pts.shape[2],
            0 if skip is None else skip.shape[-1])))
        times = {}
        for plan, run in tk.forced_plans("interp_mm", args).items():
            tk.max_abs_err(tk.flatten(run()), want)
            times[plan] = tk.device_ms(run, KERNEL_ITERS, DEVICE_SYMBOLS["interp_mm"])[0]
        plans[label] = times
        print(f"interp_mm plan sweep [{label}]: device ms by rows x slices x stage (bitwise the "
              "plain version at each) " + ", ".join(
                  f"{plan}: {ms}{' (picked)' * (plan == pick)}" for plan, ms in times.items()))
    next(e for e in entries if e["name"] == "interp_mm")["ms_by_plan"] = plans

    # the two-way argmin at every count of CTAs a row at 16 rows x 4096, kernel
    # only (bitwise the plain version each time), device ms; the plan's
    # pick marked
    from gspn_tpu_torch.ops import chamfer as tchamfer

    want = tk.flatten(ops.nn_argmin_pair(tie_tgt, tie_src, tie_valid1, tie_valid, impl="plain"))
    pick = tchamfer.nn_argmin_plan(tie_tgt.shape[1])
    times = {}
    for ctas, run in tk.forced_plans("nn_argmin", (tie_tgt, tie_src, tie_valid1,
                                                   tie_valid)).items():
        tk.max_abs_err(tk.flatten(run()), want)
        times[ctas] = tk.device_ms(run, KERNEL_ITERS, DEVICE_SYMBOLS["nn_argmin"])[0]
    print("nn_argmin CTA sweep [16 rows x 4096 <-> 4096 both ways]: device ms by CTAs a row "
          "(bitwise the plain version at each) " + ", ".join(
              f"{cs}: {ms}{' (picked)' * (cs == pick)}" for cs, ms in times.items()))
    next(e for e in entries if e["name"] == "nn_argmin")["ms_by_ctas"] = times

    # NMS, index_add, the FP interpolation and the chamfer argmins at their
    # ranked shapes: the whole of nms_3d_batched, index_add_rows,
    # three_interpolate_fp (with and without the skip rows) and
    # nn_argmin_pair must be one device operation (the kernel) a call
    for name in ("nms", "index_add", "interp_mm", "nn_argmin"):
        per_call = {}
        for label, a, reqs in main_path[name]:
            if not reqs:
                continue
            call = lambda a=a, name=name: tk.call(ops, name, a, "cuda")  # noqa: E731
            per_call[label] = tk.device_launches(call, KERNEL_ITERS)
            print(f"{name} [{label}]: wrapper {tk.cuda_ms(call, KERNEL_ITERS):.4f} ms, "
                  f"{per_call[label]:g} device operations a call (torch.profiler)")
            if per_call[label] != 1:
                raise AssertionError(f"{name} [{label}]: {per_call[label]} device operations "
                                     "a call")
        next(e for e in entries if e["name"] == name)["device_ops_per_call"] = per_call

    # each (F) ball query beside the ball group at the same shape and plan:
    # the same kernel without the coordinate stores
    by = {e["name"]: e for e in entries}
    for query, group in (("ball_query", "ball_group"), ("ball_query_strided",
                                                        "ball_group_strided")):
        for label, q_ms in by[query]["device_ms_by_shape"].items():
            g_ms = by[group]["device_ms_by_shape"][label]
            ratio = "not measured" if None in (q_ms, g_ms) else f"{q_ms / g_ms:.3f}"
            print(f"{query} [{label}]: device {q_ms} ms, {group} {g_ms} ms, ratio {ratio}")

    first_k = ops.query_ball_group_multi((0.1,), (32,), xyz, sa1, valid)[0][0]
    strided = ops.query_ball_group_multi((0.1,), (32,), xyz, sa1, valid, select="strided")[0][0]
    rows = (first_k != strided).any(dim=-1).sum().item()
    if not rows:
        raise AssertionError("sa1: strided selection equals first-K")
    print(f"sa1: strided selection differs from first-K in {rows} of {B * 1024} balls")
    return entries, requests, model_floors


def _cpu_reference(name, infer, model, cpu_model, sx, sv, seps, dev) -> None:
    """A second reference: the CPU's plain path (the one the CPU tests hold
    against JAX) on a small scene; the MLPs' matmul sums differ between CPU
    and GPU, so masks may flip at a logit's threshold: allow 1e-3 of
    them."""
    gpu = infer(model, sx.to(dev), sv.to(dev), z_eps=seps.to(dev))
    cpu = infer(cpu_model, sx, sv, z_eps=seps)
    flips = (gpu.masks.cpu() != cpu.masks).float().mean().item()
    if flips > 1e-3 or not torch.equal(gpu.valid.cpu(), cpu.valid):
        raise AssertionError(f"({name}) GPU vs CPU on a small scene: mask flips {flips}, "
                             f"valid equal {torch.equal(gpu.valid.cpu(), cpu.valid)}")
    torch.testing.assert_close(gpu.boxes.cpu(), cpu.boxes, rtol=1e-4, atol=1e-4)
    print(f"slice ({name}) B=1 x N={sx.shape[1]}: GPU kernel path vs CPU plain path: valid "
          f"equal, mask flips {flips}, boxes within 1e-4")


def _timed_requests(infer, model, req, n_requests):
    """One warm-up request, then ``n_requests`` timed ones on the host clock
    around a synchronized call. Returns ``(ms per request, output)`` and
    raises unless every timed request gave the same output."""
    xyz, valid, eps, *feats = req  # (L)'s RGB requests carry features
    features = feats[0] if feats else None
    infer(model, xyz, valid, z_eps=eps, features=features)
    times, first = [], None
    for _ in range(n_requests):
        ms, out = _host_ms(lambda: infer(model, xyz, valid, z_eps=eps, features=features))
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

        # (H) the exact greedy FPS (scannet_pipeline(fps_segments=1)): at the
        # whole scene one 1024-pick chain over 65536 points on the cluster
        # kernel a request, at the flagship eight 8192-point rows on fps
        ecfg = bench_slice.variant_config("exact")
        emodel = bench_slice.rebuilt_model(ecfg, model)
        exact, eplain, runs["H"] = run_slice("H", ops, bench_slice, ecfg, emodel, reqs,
                                             VARIANT_REQUESTS)
        if runs["H"]["fps_cluster"] != VARIANT_REQUESTS + 1:
            raise AssertionError(f"(H): {runs['H']['fps_cluster']} fps_cluster launches, "
                                 f"expected one per whole-scene request")
        for shape in reqs:
            points = reqs[shape][0].shape[0] * reqs[shape][0].shape[1]
            for path, (times, _) in (("kernel", exact[shape]), ("plain", eplain[shape])):
                print(f"slice (H) {shape} {path} path: {_spread(times)}, "
                      f"{points / statistics.median(times) * 1e3:.0f} points/s [{card}]")

        _phase("cpu reference")
        infer = make_inference_fn(cfg)
        sb = synthetic.scene_batch(np.random.default_rng(0), 1, n_points=2048,
                                   max_instances=4, extent=2.0)
        sx, sv = torch.from_numpy(sb["xyz"]), torch.from_numpy(sb["valid"])
        seps = torch.randn((1, cfg.num_seeds, cfg.gspn.latent_dim),
                           generator=torch.Generator().manual_seed(3))
        cpu_model = bench_slice.seeded_model(cfg, torch.device("cpu"))
        _cpu_reference("A", infer, model, cpu_model, sx, sv, seps, dev)
        # (H) on a scene above one block's FPS row (14,272 points), so the
        # card's side runs the cluster kernel
        sb = synthetic.scene_batch(np.random.default_rng(0), 1, n_points=16384,
                                   max_instances=4, extent=2.0)
        before = ops.launch_counts()["fps_cluster"]
        _cpu_reference("H", make_inference_fn(ecfg), emodel,
                       bench_slice.rebuilt_model(ecfg, cpu_model),
                       torch.from_numpy(sb["xyz"]), torch.from_numpy(sb["valid"]), seps, dev)
        if ops.launch_counts()["fps_cluster"] != before + 1:
            raise AssertionError("(H) B=1 x N=16384: the card did not run fps_cluster")

    for shape, (times, _) in kernel.items():
        points = reqs[shape][0].shape[0] * reqs[shape][0].shape[1]
        print(f"slice (A) {shape} kernel path: {_spread(times)}, "
              f"{points / statistics.median(times) * 1e3:.0f} points/s; "
              f"plain path {_spread(plain[shape][0])} [{card}]")
        print(f"slice (A) {shape} kernel path requests ms: {[round(x, 3) for x in times]}")
    return runs


def _serving_checkpoints(cfg, state, work):
    """``state``'s two stages as the trainers' ``CheckpointManager`` writes
    them (a GSPN with its recognition network, an R-PointNet, each with its
    Adam state) under ``work``: ``(gspn_ckpt, rpointnet_ckpt)``."""
    from gspn_tpu_torch.models.gspn import GSPN
    from gspn_tpu_torch.models.rpointnet import RPointNet
    from gspn_tpu_torch.train.checkpoint import CheckpointManager
    from gspn_tpu_torch.train.steps import TrainState, make_optimizer

    dirs = []
    for name, stage in (("gspn", GSPN(cfg.gspn, recognition=True)),
                        ("rpointnet", RPointNet(cfg.rpointnet))):
        stage.load_state_dict({k[len(name) + 1:]: v for k, v in state.items()
                               if k.startswith(f"{name}.")}, strict=name != "gspn")
        path = pathlib.Path(work) / f"serve_{name}" / "ckpt"
        CheckpointManager(path).save(TrainState(stage, make_optimizer(stage, 1e-3), 1))
        dirs.append(path)
    return dirs


def _live_answer(infer, model, xyz, valid, seed, batch, noise_shape):
    """What a session must answer for ``xyz (b, n, 3)`` and ``valid``
    (numpy), by the live kernel path: chunks of ``batch`` scenes, the last
    padded with copies of its first scene, chunk ``ci`` with
    ``chunk_noise(seed, ci)``."""
    from gspn_tpu_torch.serve.runtime import chunk_noise

    dev = next(model.parameters()).device
    outs = []
    for ci, lo in enumerate(range(0, xyz.shape[0], batch)):
        take = min(batch, xyz.shape[0] - lo)
        x, v = (torch.from_numpy(np.concatenate([a[lo:lo + take]] + [a[lo:lo + 1]] *
                                                (batch - take))).to(dev) for a in (xyz, valid))
        p = infer(model, x, v, z_eps=chunk_noise(seed, ci, noise_shape).to(dev))
        outs.append({f: getattr(p, f)[:take].cpu().numpy() for f in FIELDS})
    return {f: np.concatenate([o[f] for o in outs]) for f in FIELDS}


def _profile_window(fn, iters: int = 5):
    """``(wall ms, device busy ms, idle share, device operations)`` a call
    of ``fn`` under ``torch.profiler`` over ``iters`` calls after a
    warm-up; busy is the union of the device's kernel and copy intervals."""
    from torch.profiler import ProfilerActivity, profile

    from gspn_tpu_torch.utils.profiling import busy_us, device_kernels

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    events = device_kernels(prof)
    busy = busy_us(events) / 1e3 / iters
    return wall, busy, 1.0 - busy / wall, len(events) / iters


def _times(fn, n: int) -> list[float]:
    """Host ms of ``n`` synchronized calls of ``fn`` after one warm-up."""
    fn()
    return [_host_ms(fn)[0] for _ in range(n)]


def _span(times) -> str:
    return f"{statistics.median(times):.3f} ({min(times):.3f}-{max(times):.3f})"


def _device_ops(fn, windows: int = 3) -> int:
    """Device operations (kernels, copies, fills) of one call of ``fn``: the
    most over ``windows`` profiler windows of one call each (CUPTI drops a
    record now and then, never adds one)."""
    return max(round(tk.device_launches(fn, 1)) for _ in range(windows))


def run_serving(dev, ops, bench_slice, card, work):
    """Slice (J): serving. For the flagship and the whole scene, the slice's
    pipeline (``bench_slice.slice_config()``) exported for ``cuda``
    (``serve.export_inference``), written and loaded back, served by
    ``session_from_checkpoints`` from checkpoints that ``CheckpointManager``
    wrote of other seeded weights, behind a ``Server`` on a unix socket; a
    ``Client``'s requests (flagship batches of 8, 3 and 11, two whole-scene
    requests) bitwise the live kernel path's answers with the same noise;
    ``make_streamed_inference_fn`` over T=4 batches bitwise 4 eager calls,
    a second run (replaying the first's kept capture) bitwise the first,
    and within the parity tolerances of the plain path (eager, no launch);
    the capture's launches each twice an eager request's (its warm-up and
    the capture), the replays' none; a
    replayed request's device operations against the exported program's
    eager call's; then host ms a request of each way in and the replay's
    device busy ms and idle share. It runs in a process of its own
    (``run_serving_process``). Returns ``(the
    launch counts of the sessions' and the streamed runs' captures, an
    eager request's launch counts)``; ``main`` holds the latter against
    (A)'s."""
    from gspn_tpu_torch.models.pipeline import (
        PREDICTION_FIELDS, PipelineModel, init_pipeline_variables, make_inference_fn,
        make_streamed_inference_fn,
    )
    from gspn_tpu_torch.serve import Client, Server, export_inference, save_artifact
    from gspn_tpu_torch.serve import session_from_checkpoints

    cfg = bench_slice.slice_config()
    infer = make_inference_fn(cfg)
    trained = init_pipeline_variables(cfg, torch.Generator().manual_seed(1), N)
    model = PipelineModel(cfg)
    model.load_state_dict(trained)
    model = model.to(dev).eval()
    pcfg, pmodel = bench_slice.plain_model(cfg, model)
    infer_plain = make_inference_fn(pcfg)
    gspn_ckpt, rpn_ckpt = _serving_checkpoints(cfg, trained, work)
    total = {k: 0 for k in ops.launch_counts()}
    per_request = None
    with torch.inference_mode():
        for shape in (FLAGSHIP, WHOLE_SCENE):
            x, v, e = bench_slice.request(cfg, shape, dev, 1)
            ops.reset_launch_counts()
            infer(model, x, v, z_eps=e)
            if per_request not in (None, ops.launch_counts()):
                raise AssertionError(f"(J) the two shapes' requests launch {per_request} and "
                                     f"{ops.launch_counts()}")
            per_request = ops.launch_counts()

    def counted(what, fn, runs=1):
        """``fn()`` with the launch counts set to 0 just before and read
        just after: each kernel of a request twice a run (warm-up and
        capture), the others none."""
        ops.reset_launch_counts()
        out = fn()
        counts = ops.launch_counts()
        want = {k: 2 * runs * per_request.get(k, 0) for k in counts}
        if counts != want:
            raise AssertionError(f"(J) {what}: launches {counts}, expected {want}")
        for k, c in counts.items():
            total[k] += c
        return out

    for shape in (FLAGSHIP, WHOLE_SCENE):
        b, n = bench_slice.SHAPES[shape][:2]
        xyz, valid = bench_slice.scenes(shape)
        with torch.inference_mode():
            t0 = time.perf_counter()
            program = export_inference(cfg, model, n, batch_size=b, device=dev)
            export_s = time.perf_counter() - t0
            path = save_artifact(pathlib.Path(work) / f"{shape}.gspnt", program, cfg)
        t0 = time.perf_counter()
        session = counted(f"{shape} session", lambda: session_from_checkpoints(
            path, gspn_ckpt, rpn_ckpt, device=dev))
        print(f"slice (J) {shape}: exported in {export_s:.1f} s, artifact "
              f"{path.stat().st_size} bytes; session (load, checkpoints, warm-up and capture) "
              f"in {time.perf_counter() - t0:.1f} s")
        if shape == FLAGSHIP:
            more = np.ascontiguousarray(xyz[:3, ::-1])
            requests = [(xyz, valid, 0), (xyz[:3], valid[:3], 1),
                        (np.concatenate([xyz, more]), np.concatenate([valid, valid[:3, ::-1]]), 2)]
        else:
            requests = [(xyz, valid, 0), (np.ascontiguousarray(xyz[:, ::-1]), valid, 1)]
        sock = pathlib.Path(work) / "gspn.sock"
        ops.reset_launch_counts()
        with Server(session, sock), Client(sock) as client:
            answers = [client.predict(x, v, seed=s) for x, v, s in requests]
            if any(ops.launch_counts().values()):
                raise AssertionError(f"(J) {shape}: a replayed request launched from Python")
            with torch.inference_mode():
                for (x, v, s), got in zip(requests, answers, strict=True):
                    want = _live_answer(infer, model, x, v, s, b, session.noise_shape)
                    for f in PREDICTION_FIELDS:
                        if not np.array_equal(got[f], want[f]):
                            raise AssertionError(f"(J) {shape} batch of {len(x)}: the server's "
                                                 f"{f} differs from the live kernel path's")
                    share = got["masks"][got["valid"]].mean() if got["valid"].any() else 0.0
                    if not 0.0 < share < 1.0:
                        raise AssertionError(f"(J) {shape}: masks of valid instances hold "
                                             f"{share} of the points")
                    print(f"slice (J) {shape}: a client's batch of {len(x)} == the live kernel "
                          f"path (every output bitwise); {int(got['valid'].sum())} valid "
                          f"instances, mask share {share:.4f}")

            # streamed: T=4 batches of this shape
            gen = torch.Generator().manual_seed(4)
            xs = torch.from_numpy(xyz).to(dev)
            xyz_s = torch.stack([xs, xs.flip(1), xs * 0.9, xs * 1.1])
            valid_s = torch.from_numpy(valid).to(dev)[None].expand(4, -1, -1).clone()
            valid_s[1] = valid_s[1].flip(1)
            eps_s = torch.randn((4, *session.noise_shape), generator=gen).to(dev)
            streamed = make_streamed_inference_fn(cfg)
            with torch.inference_mode():
                got = counted(f"{shape} streamed", lambda: streamed(model, xyz_s, valid_s, eps_s))
                again = counted(f"{shape} streamed again (the kept capture)",
                                lambda: streamed(model, xyz_s, valid_s, eps_s), runs=0)
                eager = [infer(model, xyz_s[i], valid_s[i], z_eps=eps_s[i]) for i in range(4)]
                before = ops.launch_counts()
                plain = [infer_plain(pmodel, xyz_s[i], valid_s[i], z_eps=eps_s[i])
                         for i in range(4)]
                if ops.launch_counts() != before:
                    raise AssertionError(f"(J) {shape}: the plain path launched kernels")
            for i in range(4):
                for f in PREDICTION_FIELDS:
                    g = getattr(got, f)[i]
                    if not (torch.equal(g, getattr(eager[i], f))
                            and torch.equal(g, getattr(again, f)[i])):
                        raise AssertionError(f"(J) {shape} streamed batch {i}: {f} differs "
                                             "from the eager call or from the second run")
                for f in ("masks", "valid", "classes"):
                    if not torch.equal(getattr(got, f)[i], getattr(plain[i], f)):
                        raise AssertionError(f"(J) {shape} streamed batch {i}: {f} differs "
                                             "from the plain path")
                for f in ("scores", "boxes"):
                    torch.testing.assert_close(getattr(got, f)[i], getattr(plain[i], f),
                                               rtol=1e-4, atol=1e-5)
            print(f"slice (J) {shape}: streamed T=4 (one capture, four replays) == 4 eager "
                  "kernel-path calls and a second streamed run replaying the kept capture "
                  "(bitwise, no launch), == the plain path "
                  "(masks, valid, classes; scores, boxes within rtol 1e-4 atol 1e-5)")

            # device operations and times a request
            x0, v0 = (torch.from_numpy(a).to(dev) for a in (xyz, valid))
            e0 = eps_s[0]
            with torch.inference_mode():
                calls = {
                    "eager kernel path infer": lambda: infer(model, x0, v0, z_eps=e0),
                    "exported program, eager": lambda: session.module(session.state, x0, v0, e0),
                    "session.run (graph replay)": lambda: session.run(x0, v0, e0),
                }
                dev_ops = {k: _device_ops(fn) for k, fn in calls.items()}
                if dev_ops["session.run (graph replay)"] != dev_ops[
                        "exported program, eager"] + 8:
                    raise AssertionError(f"(J) {shape}: device operations a request {dev_ops}; "
                                         "a replay is the program's plus 3 input copies and 5 "
                                         "output clones")
                print(f"slice (J) {shape}: device operations a request: "
                      + ", ".join(f"{k} {v}" for k, v in dev_ops.items()))
                times = {k: _times(fn, REQUESTS) for k, fn in calls.items()}
                times["session.predict (numpy in and out)"] = _times(
                    lambda: session.predict(xyz, valid, seed=0), REQUESTS)
                times["client round trip"] = _times(
                    lambda: client.predict(xyz, valid, seed=0), REQUESTS)
                times["streamed T=4, a batch"] = [t / 4 for t in _times(
                    lambda: streamed(model, xyz_s, valid_s, eps_s), REQUESTS)]
                windows = {k: _profile_window(calls[k]) for k in (
                    "eager kernel path infer", "session.run (graph replay)")}
            ops.reset_launch_counts()  # the timed eager calls' launches are not (J)'s counts
            for k, v in times.items():
                print(f"slice (J) {shape} {k}: median (min-max) {_span(v)} ms a request, "
                      f"{len(v)} after a warm-up [{card}]")
            for k, (wall, busy, idle, _) in windows.items():
                print(f"slice (J) {shape} {k} under torch.profiler: wall {wall:.3f} ms, device "
                      f"busy {busy:.3f} ms, idle share {idle:.3f} a request [{card}]")
        del session
    return total, per_request


def _train_steps(bench_slice, model, batch, eps, n_steps):
    """Train ``model`` (Adam at 1e-3, as ``train_gspn``'s default) for one
    warm-up step and ``n_steps`` timed ones on the host clock around a
    synchronized step, the same batch and noise each step. Returns ``(step
    1's metrics, step 1's gradients, every step's loss, timed ms)``."""
    from gspn_tpu_torch.train.steps import (
        TrainState, make_gspn_loss_fn, make_optimizer, make_train_step,
    )

    loss_fn = make_gspn_loss_fn(bench_slice.TRAIN_SEEDS, bench_slice.TRAIN_GT)
    step = make_train_step(loss_fn)
    state = TrainState(model, make_optimizer(model, 1e-3))
    first = step(state, batch, z_eps=eps)
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    losses, times = [first["loss"]], []
    for _ in range(n_steps):
        ms, m = _host_ms(lambda: step(state, batch, z_eps=eps))
        times.append(ms)
        losses.append(m["loss"])
    return first, grads, torch.stack(losses), times


def run_training(dev, ops, bench_slice, card, work):
    """Slice (G): GSPN stage-1 training steps on the card, kernel path
    against plain path, then a CPU reference and the trainer's entry point,
    whose run at its defaults leaves its checkpoints under ``work/gspn``
    for slice (I). Returns the kernel path's launch counts."""
    import pathlib
    import tempfile

    from gspn_tpu_torch.nn.layers import MaskedBatchNorm
    from gspn_tpu_torch.train import train_gspn
    from gspn_tpu_torch.train.steps import make_gspn_loss_fn

    _phase("slice (G)")
    cfg = bench_slice.train_config()
    batch = bench_slice.train_batch(dev)
    model = bench_slice.seeded_gspn(cfg, dev)
    _, pmodel = bench_slice.plain_gspn(cfg, model)  # same initial weights
    eps = torch.randn((bench_slice.TRAIN_BATCH, bench_slice.TRAIN_SEEDS, cfg.latent_dim),
                      generator=torch.Generator().manual_seed(1)).to(dev)
    _deterministic_mode_diagnostic(bench_slice, cfg, batch, eps)
    ops.reset_launch_counts()
    first, grads, losses, times = _train_steps(bench_slice, model, batch, eps, TRAIN_STEPS)
    counts = ops.launch_counts()
    print(f"slice (G) launches: {json.dumps(counts)}")
    want = {k: c * (TRAIN_STEPS + 1) for k, c in G_PER_STEP.items()}
    got = {k: c for k, c in counts.items() if c}
    if got != want:
        raise AssertionError(f"slice (G) launched {got}, expected {want}")
    # a second kernel-path run from the same weights: bitwise the first
    again = bench_slice.seeded_gspn(cfg, dev)
    _, _, losses2, _ = _train_steps(bench_slice, again, batch, eps, TRAIN_STEPS)
    _assert_same_training("two kernel-path runs", model, again, losses, losses2)
    print(f"slice (G): a second kernel-path run of 1 + {TRAIN_STEPS} steps from the same "
          "weights: losses, parameters and running statistics bitwise equal")
    rerun = ops.launch_counts()
    pfirst, pgrads, plosses, ptimes = _train_steps(bench_slice, pmodel, batch, eps, TRAIN_STEPS)
    if ops.launch_counts() != rerun:
        raise AssertionError("slice (G): the plain path launched kernels")

    for name, ls in (("kernel", losses), ("plain", plosses)):
        if not torch.isfinite(ls).all():
            raise AssertionError(f"slice (G) {name} path: non-finite losses {ls.tolist()}")
    # every kernel is bitwise its plain version and every sum of a step is
    # taken in a fixed order, so the two paths train the same model bit for
    # bit: step 1's loss, terms and gradients, every later loss, and the
    # parameters and running statistics at the end
    gaps = ((losses - plosses).abs() / plosses.abs()).tolist()
    print(f"slice (G): kernel path vs plain path, relative loss gap per step "
          f"{[f'{g:.2e}' for g in gaps]}")
    for k in first:
        if not torch.equal(first[k], pfirst[k]):
            raise AssertionError(f"slice (G): step 1 {k} {first[k].item()} vs {pfirst[k].item()}")
    differ = [k for k in grads if not torch.equal(grads[k], pgrads[k])]
    if differ:
        raise AssertionError(f"slice (G): step-1 gradients differ in {differ[:3]}")
    _assert_same_training("kernel path vs plain path", model, pmodel, losses, plosses)
    still = [k for k, m in model.named_modules()
             if isinstance(m, MaskedBatchNorm) and not m.mean.any()]
    if still:
        raise AssertionError(f"slice (G): running means still 0 in {still}")
    print(f"slice (G): step 1 loss {first['loss'].item():.6f} "
          f"({', '.join(f'{k} {v.item():.6f}' for k, v in first.items() if k != 'loss')}), "
          f"kernel path == plain path bitwise (losses, step-1 gradients, parameters); "
          f"losses {[round(x, 4) for x in losses.tolist()]}")
    for name, ts in (("kernel", times), ("plain", ptimes)):
        med = statistics.median(ts)
        print(f"slice (G) {name} path: median {med:.3f} ms/step (min {min(ts):.3f}, max "
              f"{max(ts):.3f}; {len(ts)} steps after a warm-up), "
              f"{bench_slice.TRAIN_BATCH / med * 1e3:.2f} scenes/s [{card}]")

    _phase("slice (G) cpu reference")
    def small_step_loss(device):
        b = bench_slice.train_batch(device, b=1, n=1024)
        seps = torch.randn((1, 16, cfg.latent_dim), generator=torch.Generator().manual_seed(2))
        return make_gspn_loss_fn(16, 64)(
            bench_slice.seeded_gspn(cfg, device), b, z_eps=seps.to(device))[0].item()

    on_card, on_cpu = small_step_loss(dev), small_step_loss(torch.device("cpu"))
    if abs(on_card - on_cpu) > 1e-4 * abs(on_cpu):
        raise AssertionError(f"slice (G) B=1 x N=1024: card {on_card} vs CPU {on_cpu}")
    print(f"slice (G) B=1 x N=1024, 16 seeds, GT 64: step 1 loss card kernel path "
          f"{on_card:.6f}, CPU plain path {on_cpu:.6f} (within rtol 1e-4)")

    _phase("slice (G) train_gspn")
    tmp = str(pathlib.Path(work, "gspn"))
    state = train_gspn.main(["--steps", "3", "--log-every", "1", "--ckpt-every", "3",
                             "--log-dir", tmp])
    lines = [json.loads(x) for x in pathlib.Path(tmp, "train.jsonl").read_text().splitlines()]
    if state.step != 3 or len(lines) != 3 or not all(
            np.isfinite(v) for rec in lines for v in rec.values()):
        raise AssertionError(f"train_gspn: step {state.step}, metrics {lines}")
    if not pathlib.Path(tmp, "ckpt", "ckpt_3.pt").exists():
        raise AssertionError("train_gspn: no checkpoint at step 3")
    print(f"slice (G) train_gspn.main at its defaults: 3 steps, 3 finite metric lines, "
          f"checkpoint ckpt_3.pt; last loss {lines[-1]['loss']:.4f}")

    _phase("slice (G) train_gspn --resume")
    with tempfile.TemporaryDirectory() as tmp:
        run = ["--ckpt-every", "1", "--log-every", "1"]
        straight = train_gspn.main(run + ["--steps", "4", "--log-dir", f"{tmp}/a"])
        train_gspn.main(run + ["--steps", "2", "--log-dir", f"{tmp}/b"])
        resumed = train_gspn.main(run + ["--steps", "4", "--resume", "--log-dir", f"{tmp}/b"])
        la, lb = (json.loads(x)["loss"] for x in pathlib.Path(tmp, "a", "train.jsonl")
                  .read_text().splitlines()), (json.loads(x)["loss"] for x in pathlib.Path(
                      tmp, "b", "train.jsonl").read_text().splitlines())
        la, lb = torch.tensor(list(la)), torch.tensor(list(lb))
        _assert_same_training("train_gspn 4 steps vs 2 + --resume 2", straight.model,
                              resumed.model, la, lb)
        oa, ob = (st.optimizer.state_dict()["state"] for st in (straight, resumed))
        # a restored Adam keeps its step count where the checkpoint load put it
        if not all(torch.equal(oa[i][k].cpu(), ob[i][k].cpu()) for i in oa for k in oa[i]):
            raise AssertionError("train_gspn --resume: Adam moments differ")
    print(f"slice (G) train_gspn: 4 steps straight == 2 steps, a checkpoint and --resume "
          f"for 2 (parameters, running statistics, Adam moments, losses bitwise); "
          f"losses {la.tolist()}")

    _phase("slice (G) train_gspn --num-points 16384")
    before = ops.launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        state = train_gspn.main(["--num-points", "16384", "--steps", "3", "--log-every", "1",
                                 "--ckpt-every", "3", "--log-dir", tmp])
        lines = [json.loads(x) for x in pathlib.Path(tmp, "train.jsonl").read_text().splitlines()]
        if state.step != 3 or len(lines) != 3 or not all(
                np.isfinite(v) for rec in lines for v in rec.values()):
            raise AssertionError(f"train_gspn --num-points 16384: step {state.step}, "
                                 f"metrics {lines}")
        if not pathlib.Path(tmp, "ckpt", "ckpt_3.pt").exists():
            raise AssertionError("train_gspn --num-points 16384: no checkpoint at step 3")
    cluster = ops.launch_counts()["fps_cluster"] - before["fps_cluster"]
    if cluster != 3:
        raise AssertionError(f"train_gspn --num-points 16384: {cluster} fps_cluster launches")
    print(f"slice (G) train_gspn --num-points 16384 (exact FPS, --fps-segments 1): 3 steps, "
          f"3 finite metric lines, checkpoint ckpt_3.pt, fps_cluster once a step; last loss "
          f"{lines[-1]['loss']:.4f}")
    return counts


def _stage2_steps(bench_slice, model, gmodel, batch, draws, n_steps):
    """Train the R-PointNet ``model`` over the frozen ``gmodel``'s proposals
    (Adam at 1e-3, as ``train_rpointnet``'s default) for one warm-up step
    and ``n_steps`` timed ones on the host clock around a synchronized step,
    the same batch and noise each step. Returns ``(step 1's metrics, step
    1's gradients, every step's loss, timed ms)``."""
    from gspn_tpu_torch.train.steps import (
        TrainState, make_optimizer, make_rpointnet_loss_fn, make_train_step,
    )

    step = make_train_step(make_rpointnet_loss_fn(
        bench_slice.STAGE2_INSTANCES, (gmodel, bench_slice.TRAIN_SEEDS)))
    state = TrainState(model, make_optimizer(model, 1e-3))
    first = step(state, batch, **draws)
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    losses, times = [first["loss"]], []
    for _ in range(n_steps):
        ms, m = _host_ms(lambda: step(state, batch, **draws))
        times.append(ms)
        losses.append(m["loss"])
    return first, grads, torch.stack(losses), times


def _stage2_draws(gcfg, b: int, seed: int, device) -> dict:
    """A stage-2 step's noise from ``torch.Generator().manual_seed(seed)``:
    the GT boxes' jitter, then the frozen GSPN's CVAE noise."""
    gen = torch.Generator().manual_seed(seed)
    from gspn_tpu_torch.utils.bench_slice import STAGE2_INSTANCES, TRAIN_SEEDS

    return {"box_noise": torch.randn((b, STAGE2_INSTANCES, 6), generator=gen).to(device),
            "z_eps": torch.randn((b, TRAIN_SEEDS, gcfg.latent_dim), generator=gen).to(device)}


def run_stage2(dev, ops, bench_slice, card, work):
    """Slice (I): R-PointNet stage-2 training steps on the card over a frozen
    GSPN's proposals, kernel path against plain path, then a CPU reference
    and the trainer's entry point (with ``--gspn-ckpt`` on (G)'s checkpoint
    under ``work/gspn/ckpt``). Returns the kernel path's launch counts."""
    import pathlib

    from gspn_tpu_torch.nn.layers import MaskedBatchNorm
    from gspn_tpu_torch.train import train_rpointnet
    from gspn_tpu_torch.train.steps import make_rpointnet_loss_fn

    _phase("slice (I)")
    gcfg, rcfg = bench_slice.stage2_configs()
    batch = bench_slice.train_batch(dev)
    b, n = batch["xyz"].shape[:2]
    gmodel = bench_slice.seeded_frozen_gspn(gcfg, dev)
    _, pgmodel = bench_slice.plain_gspn(gcfg, gmodel)  # same weights, eval mode
    model = bench_slice.seeded_rpointnet(rcfg, dev)
    _, pmodel = bench_slice.plain_rpointnet(rcfg, model)  # same initial weights
    draws = _stage2_draws(gcfg, b, 1, dev)
    ops.reset_launch_counts()
    first, grads, losses, times = _stage2_steps(bench_slice, model, gmodel, batch, draws,
                                                TRAIN_STEPS)
    counts = ops.launch_counts()
    print(f"slice (I) launches: {json.dumps(counts)}")
    want = {k: c * (TRAIN_STEPS + 1) for k, c in I_PER_STEP.items()}
    got = {k: c for k, c in counts.items() if c}
    if got != want:
        raise AssertionError(f"slice (I) launched {got}, expected {want}")
    again = bench_slice.seeded_rpointnet(rcfg, dev)
    _, _, losses2, _ = _stage2_steps(bench_slice, again, gmodel, batch, draws, TRAIN_STEPS)
    _assert_same_training("(I) two kernel-path runs", model, again, losses, losses2)
    print(f"slice (I): a second kernel-path run of 1 + {TRAIN_STEPS} steps from the same "
          "weights: losses, parameters and running statistics bitwise equal")
    rerun = ops.launch_counts()
    pfirst, pgrads, plosses, ptimes = _stage2_steps(bench_slice, pmodel, pgmodel, batch, draws,
                                                    TRAIN_STEPS)
    if ops.launch_counts() != rerun:
        raise AssertionError("slice (I): the plain path launched kernels")
    for name, ls in (("kernel", losses), ("plain", plosses)):
        if not torch.isfinite(ls).all():
            raise AssertionError(f"slice (I) {name} path: non-finite losses {ls.tolist()}")
    for k in first:
        if not torch.equal(first[k], pfirst[k]):
            raise AssertionError(f"slice (I): step 1 {k} {first[k].item()} vs {pfirst[k].item()}")
    differ = [k for k in grads if not torch.equal(grads[k], pgrads[k])]
    if differ:
        raise AssertionError(f"slice (I): step-1 gradients differ in {differ[:3]}")
    _assert_same_training("(I) kernel path vs plain path", model, pmodel, losses, plosses)
    still = [k for k, m in model.named_modules()
             if isinstance(m, MaskedBatchNorm) and not m.mean.any()]
    if still:
        raise AssertionError(f"slice (I): running means still 0 in {still}")
    if not first["num_fg"].item() > 0:
        raise AssertionError(f"slice (I): step 1 has no foreground RoI ({first})")
    print(f"slice (I): step 1 loss {first['loss'].item():.6f} "
          f"({', '.join(f'{k} {v.item():.6f}' for k, v in first.items() if k != 'loss')}), "
          f"kernel path == plain path bitwise (losses, step-1 gradients, parameters, running "
          f"statistics); losses {[round(x, 4) for x in losses.tolist()]}")
    for name, ts in (("kernel", times), ("plain", ptimes)):
        med = statistics.median(ts)
        print(f"slice (I) {name} path: median {med:.3f} ms/step (min {min(ts):.3f}, max "
              f"{max(ts):.3f}; {len(ts)} steps after a warm-up), "
              f"{b * n / med * 1e3:.0f} points/s [{card}]")

    _phase("slice (I) cpu reference")

    def small_step_loss(device):
        sb = bench_slice.train_batch(device, b=1, n=1024)
        loss_fn = make_rpointnet_loss_fn(bench_slice.STAGE2_INSTANCES, (
            bench_slice.seeded_frozen_gspn(gcfg, device), bench_slice.TRAIN_SEEDS))
        total, metrics = loss_fn(bench_slice.seeded_rpointnet(rcfg, device), sb,
                                 **_stage2_draws(gcfg, 1, 2, device))
        return total.item(), metrics["num_fg"].item()

    (on_card, fg), (on_cpu, cpu_fg) = small_step_loss(dev), small_step_loss(torch.device("cpu"))
    if abs(on_card - on_cpu) > 1e-4 * abs(on_cpu) or fg != cpu_fg:
        raise AssertionError(f"slice (I) B=1 x N=1024: card {on_card} ({fg} fg) vs CPU "
                             f"{on_cpu} ({cpu_fg} fg)")
    print(f"slice (I) B=1 x N=1024: step 1 loss card kernel path {on_card:.6f}, CPU plain path "
          f"{on_cpu:.6f} (within rtol 1e-4), {fg:g} foreground RoIs on both")

    def lines_of(log_dir):
        return [json.loads(x) for x in pathlib.Path(log_dir, "train.jsonl").read_text()
                .splitlines()]

    gspn_ckpt = str(pathlib.Path(work, "gspn", "ckpt"))
    for phase, extra in (("", []), (" --gspn-ckpt", ["--gspn-ckpt", gspn_ckpt])):
        _phase(f"slice (I) train_rpointnet{phase}")
        log_dir = str(pathlib.Path(work, f"rpointnet{phase.strip()}"))
        state = train_rpointnet.main(["--steps", "3", "--log-every", "1", "--ckpt-every", "3",
                                      "--log-dir", log_dir] + extra)
        lines = lines_of(log_dir)
        if state.step != 3 or len(lines) != 3 or not all(
                np.isfinite(v) for rec in lines for v in rec.values()):
            raise AssertionError(f"train_rpointnet{phase}: step {state.step}, metrics {lines}")
        if not pathlib.Path(log_dir, "ckpt", "ckpt_3.pt").exists():
            raise AssertionError(f"train_rpointnet{phase}: no checkpoint at step 3")
        print(f"slice (I) train_rpointnet.main{phase or ' at its defaults (GT boxes)'}: 3 steps, "
              f"3 finite metric lines, checkpoint ckpt_3.pt; losses "
              f"{[round(r['loss'], 4) for r in lines]}, foreground / background RoIs "
              f"{[(r['num_fg'], r['num_bg']) for r in lines]}")

    _phase("slice (I) train_rpointnet --resume")
    run = ["--gspn-ckpt", gspn_ckpt, "--ckpt-every", "1", "--log-every", "1"]
    straight = train_rpointnet.main(run + ["--steps", "4", "--log-dir", f"{work}/resume_a"])
    train_rpointnet.main(run + ["--steps", "2", "--log-dir", f"{work}/resume_b"])
    resumed = train_rpointnet.main(run + ["--steps", "4", "--resume", "--log-dir",
                                          f"{work}/resume_b"])
    la, lb = (torch.tensor([r["loss"] for r in lines_of(f"{work}/resume_{x}")]) for x in "ab")
    _assert_same_training("train_rpointnet 4 steps vs 2 + --resume 2", straight.model,
                          resumed.model, la, lb)
    oa, ob = (st.optimizer.state_dict()["state"] for st in (straight, resumed))
    if not all(torch.equal(oa[i][k].cpu(), ob[i][k].cpu()) for i in oa for k in oa[i]):
        raise AssertionError("train_rpointnet --resume: Adam moments differ")
    print(f"slice (I) train_rpointnet --gspn-ckpt: 4 steps straight == 2 steps, a checkpoint and "
          f"--resume for 2 (parameters, running statistics, Adam moments, losses bitwise); "
          f"losses {la.tolist()}")
    return counts


# slice (Q): stage 2 with every option of make_rpointnet_loss_fn and the
# model's training knobs on, at (I)'s full width; the whole scene's step
Q_LOSS_WEIGHTS = {"cls_weight": 0.7, "box_weight": 1.5, "mask_weight": 0.3}
Q_JITTER, Q_DROPOUT = 0.1, 0.3
Q_WS_N = 65536


def _q_config(rcfg, **over):
    """(I)'s R-PointNet with randomized RoIs, head dropout and remat on
    (``over`` replaces any of them)."""
    import dataclasses

    return dataclasses.replace(rcfg, **{"roi_randomize": True, "head_dropout": Q_DROPOUT,
                                        "remat": True, **over})


def _q_step(bench_slice, model, gmodel, share_fps=False):
    """``one(batch, i) -> metrics``: an Adam step (1e-3) of ``model`` on the
    stage-2 loss with (Q)'s ``loss_weights`` and ``gt_box_jitter``, every
    draw of step ``i`` (the GT boxes' jitter, the frozen GSPN's noise, the
    Gumbel noise, the dropout masks) from a generator on the card seeded
    ``100 + i``, so two runs draw the same."""
    from gspn_tpu_torch.train.steps import (
        TrainState, make_optimizer, make_rpointnet_loss_fn, make_train_step,
    )

    step = make_train_step(make_rpointnet_loss_fn(
        bench_slice.STAGE2_INSTANCES, (gmodel, bench_slice.TRAIN_SEEDS),
        loss_weights=Q_LOSS_WEIGHTS, gt_box_jitter=Q_JITTER, share_fps=share_fps))
    state = TrainState(model, make_optimizer(model, 1e-3))

    def one(batch, i):
        dev = batch["xyz"].device
        return step(state, batch, generator=torch.Generator(dev).manual_seed(100 + i))

    return one


def _q_steps(bench_slice, model, gmodel, batch, n_steps, share_fps=False):
    """1 + ``n_steps`` steps of :func:`_q_step`. Returns ``(step 1's metrics,
    step 1's gradients, every loss, host ms of the timed steps)``."""
    one = _q_step(bench_slice, model, gmodel, share_fps)
    first = one(batch, 0)
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    losses, times = [first["loss"]], []
    for i in range(1, n_steps + 1):
        ms, m = _host_ms(lambda i=i: one(batch, i))
        times.append(ms)
        losses.append(m["loss"])
    return first, grads, torch.stack(losses), times


def _q_same(what, a, b, model, other) -> None:
    """Raise unless two (Q) runs (``_q_steps``' results) are bitwise equal:
    step 1's metrics and gradients, every loss, the parameters and running
    statistics."""
    (fa, ga, la, _), (fb, gb, lb, _) = a, b
    for k in fa:
        if not torch.equal(fa[k], fb[k]):
            raise AssertionError(f"{what}: step 1 {k} {fa[k].item()} vs {fb[k].item()}")
    differ = [k for k in ga if not torch.equal(ga[k], gb[k])]
    if differ:
        raise AssertionError(f"{what}: step-1 gradients differ in {differ[:3]}")
    _assert_same_training(what, model, other, la, lb)


def run_options_slice(dev, ops, bench_slice, card, work):
    """Slice (Q): stage 2 at (I)'s full width (``bench_slice.stage2_configs()``,
    B=4 x N=4096, 80 RoIs a scene) with every option on: ``roi_randomize``,
    ``head_dropout`` ``Q_DROPOUT``, ``remat``, ``Q_LOSS_WEIGHTS``,
    ``gt_box_jitter`` ``Q_JITTER`` and ``share_fps=False``. 1 +
    ``TRAIN_STEPS`` steps on the kernel path (its launches counted), then
    bitwise against: its plain path; the same without ``remat``; that with
    ``share_fps=True`` (one ``fps`` launch a step fewer). ``train_rpointnet``
    at its defaults with the (Q) model config: 4 steps straight against 2,
    a checkpoint and ``--resume`` for 2. One B=1 x N=65536 step with and
    without ``remat``: bitwise, with ``torch.cuda.max_memory_allocated``
    and host ms of each. Returns the kernel path's launch counts."""
    import dataclasses

    from gspn_tpu_torch.train import train_rpointnet
    from gspn_tpu_torch.train.config_io import load_config

    _phase("slice (Q)")
    t0 = time.perf_counter()
    gcfg, rcfg = bench_slice.stage2_configs()
    qcfg = _q_config(rcfg)
    batch = bench_slice.train_batch(dev)
    b, n = batch["xyz"].shape[:2]
    gmodel = bench_slice.seeded_frozen_gspn(gcfg, dev)
    _, pgmodel = bench_slice.plain_gspn(gcfg, gmodel)

    def model_of(cfg):
        return bench_slice.seeded_rpointnet(cfg, dev)

    model = model_of(qcfg)
    _, pmodel = bench_slice.plain_rpointnet(qcfg, model)
    ops.reset_launch_counts()
    run = _q_steps(bench_slice, model, gmodel, batch, TRAIN_STEPS)
    counts = ops.launch_counts()
    print(f"slice (Q) launches: {json.dumps(counts)}")
    want = {k: c * (TRAIN_STEPS + 1) for k, c in Q_PER_STEP.items()}
    if _nonzero(counts) != want or not torch.isfinite(run[2]).all():
        raise AssertionError(f"slice (Q) launched {_nonzero(counts)}, expected {want}; losses "
                             f"{run[2].tolist()}")
    before = ops.launch_counts()
    prun = _q_steps(bench_slice, pmodel, pgmodel, batch, TRAIN_STEPS)
    if ops.launch_counts() != before:
        raise AssertionError("slice (Q): the plain path launched kernels")
    _q_same("(Q) kernel path vs plain path", run, prun, model, pmodel)
    print(f"slice (Q): roi_randomize, head_dropout {Q_DROPOUT}, remat, loss_weights "
          f"{Q_LOSS_WEIGHTS}, gt_box_jitter {Q_JITTER}, share_fps=False; kernel path == plain "
          f"path bitwise over 1 + {TRAIN_STEPS} steps (step-1 metrics and gradients, losses, "
          f"parameters, running statistics); step 1 "
          f"{', '.join(f'{k} {v.item():.6f}' for k, v in run[0].items())}; losses "
          f"{[round(x, 4) for x in run[2].tolist()]}")

    variants = {}
    for name, cfg, share in (("no remat", _q_config(rcfg, remat=False), False),
                             ("no remat, share_fps=True", _q_config(rcfg, remat=False), True)):
        other = model_of(cfg)
        ops.reset_launch_counts()
        variants[name] = (_q_steps(bench_slice, other, gmodel, batch, TRAIN_STEPS, share),
                          ops.launch_counts(), other)
    (nr, nr_counts, nr_model), (sh, sh_counts, sh_model) = variants.values()
    _q_same("(Q) remat vs no remat", run, nr, model, nr_model)
    _q_same("(Q) share_fps=False vs True", nr, sh, nr_model, sh_model)
    steps = TRAIN_STEPS + 1
    extra = {k: nr_counts[k] - sh_counts[k] for k in nr_counts if nr_counts[k] != sh_counts[k]}
    if extra != {"fps": steps}:
        raise AssertionError(f"(Q) share_fps=False launched {extra} more than True, not one fps "
                             "a step")
    recompute = {k: (counts[k] - nr_counts[k]) / steps for k in counts
                 if counts[k] != nr_counts[k]}
    print(f"slice (Q): remat == no remat bitwise, and share_fps=False == True bitwise, over 1 + "
          f"{TRAIN_STEPS} steps; share_fps=False launches one fps a step more "
          f"({nr_counts['fps'] // steps} against {sh_counts['fps'] // steps}); remat's "
          f"recompute adds a step {json.dumps(recompute)}")
    times = {"remat": run[3], "no remat": nr[3], "share_fps=True, no remat": sh[3],
             "plain path": prun[3]}
    print(f"slice (Q) host ms a step (B={b} x N={n}, {TRAIN_STEPS} steps after a warm-up): "
          + ", ".join(f"{k} {_span(v)}" for k, v in times.items()) + f" [{card}]")

    _phase("slice (Q) train_rpointnet")
    real = train_rpointnet.model_config

    def q_model_config(args, first):
        return _q_config(real(args, first))

    def lines_of(log_dir):
        return [json.loads(x) for x in pathlib.Path(log_dir, "train.jsonl").read_text()
                .splitlines()]

    train_rpointnet.model_config = q_model_config
    try:
        flags = ["--ckpt-every", "1", "--log-every", "1"]
        straight = train_rpointnet.main(flags + ["--steps", "4", "--log-dir", f"{work}/q_a"])
        train_rpointnet.main(flags + ["--steps", "2", "--log-dir", f"{work}/q_b"])
        resumed = train_rpointnet.main(flags + ["--steps", "4", "--resume",
                                                "--log-dir", f"{work}/q_b"])
    finally:
        train_rpointnet.model_config = real
    saved = load_config(f"{work}/q_a/config.json")["model"]
    if not (saved["remat"] and saved["roi_randomize"] and straight.model.config.remat):
        raise AssertionError(f"(Q) train_rpointnet: config {saved}")
    la, lb = (torch.tensor([r["loss"] for r in lines_of(f"{work}/q_{x}")]) for x in "ab")
    if not torch.isfinite(la).all():
        raise AssertionError(f"(Q) train_rpointnet: losses {la.tolist()}")
    _assert_same_training("(Q) train_rpointnet 4 steps vs 2 + --resume 2", straight.model,
                          resumed.model, la, lb)
    print(f"slice (Q) train_rpointnet.main at its defaults (GT boxes) with remat, "
          f"roi_randomize and head_dropout {Q_DROPOUT} in its model config (config.json holds "
          f"them): 4 steps straight == 2 steps, a checkpoint and --resume for 2 (parameters, "
          f"running statistics, losses bitwise); losses {la.tolist()}")

    _phase("slice (Q) whole scene")
    wbatch = bench_slice.train_batch(dev, b=1, n=Q_WS_N)
    whole = {}
    for remat in (True, False):
        one = _q_step(bench_slice, model_of(_q_config(rcfg, remat=remat)), gmodel)
        losses = [one(wbatch, 0)["loss"]]  # the warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        ms, m = _host_ms(lambda: one(wbatch, 1))
        peak = torch.cuda.max_memory_allocated(dev)
        losses.append(m["loss"])
        times = [ms] + [_host_ms(lambda i=i: one(wbatch, i))[0] for i in (2, 3)]
        whole[remat] = (peak, held, torch.stack(losses), times)
        print(f"slice (Q) B=1 x N={Q_WS_N} stage-2 step {'with' if remat else 'without'} remat "
              f"(after a warm-up step): torch.cuda.max_memory_allocated {peak / 2**20:.1f} MiB "
              f"({held / 2**20:.1f} MiB held before the step), host ms {ms:.3f} (3 steps "
              f"{_span(times)}) [{card}]")
    if not torch.equal(whole[True][2], whole[False][2]):
        raise AssertionError(f"(Q) B=1 x N={Q_WS_N}: remat losses {whole[True][2].tolist()} vs "
                             f"{whole[False][2].tolist()}")
    print(f"slice (Q) B=1 x N={Q_WS_N}: remat == no remat bitwise (2 losses "
          f"{whole[True][2].tolist()}); peak memory remat / no remat "
          f"{whole[True][0] / whole[False][0]:.3f}")
    print(f"slice (Q) {time.perf_counter() - t0:.1f} s [{card}]")
    return counts




def _r_configs(bench_slice, knob: str = "f32", width: int = 1):
    """``{1: stage 1's GSPN config, 2: (stage 2's frozen GSPN config, its
    R-PointNet config)}`` from ``bench_slice.train_config()`` and
    ``stage2_configs()``, as the trainers set ``--width-mult width`` and
    ``knob``: "f32" (the default), "bf16" (``--dtype bf16``) or "strided"
    (``--group-select strided``), on every stage."""
    import dataclasses

    from gspn_tpu_torch.models.presets import scale_gspn_widths, scale_rpointnet_widths

    def knobbed(cfg, scale):
        if width != 1:
            cfg = scale(cfg, width)
        if knob == "bf16":
            cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
        if knob == "strided":
            cfg = dataclasses.replace(cfg, group_select="strided")
        return cfg

    gcfg, rcfg = bench_slice.stage2_configs()
    return {1: knobbed(bench_slice.train_config(), scale_gspn_widths),
            2: (knobbed(gcfg, scale_gspn_widths), knobbed(rcfg, scale_rpointnet_widths))}


def _r_models(bench_slice, dev, stage: int, cfg, plain: bool = False):
    """``(model, frozen GSPN or None)`` of ``stage`` from (G)'s and (I)'s
    seeded weights; with ``plain``, their twins on the plain ops."""
    if stage == 1:
        model = bench_slice.seeded_gspn(cfg, dev)
        return (bench_slice.plain_gspn(cfg, model)[1] if plain else model), None
    gcfg, rcfg = cfg
    gmodel = bench_slice.seeded_frozen_gspn(gcfg, dev)
    model = bench_slice.seeded_rpointnet(rcfg, dev)
    if plain:
        return bench_slice.plain_rpointnet(rcfg, model)[1], bench_slice.plain_gspn(gcfg, gmodel)[1]
    return model, gmodel


def _r_run(bench_slice, dev, stage, cfg, batch, noise, plain=False):
    """1 + ``TRAIN_STEPS`` steps of ``stage`` as (G) and (I) run them (the
    same batch and noise each step): ``(_train_steps`` or
    ``_stage2_steps``' result, the model)."""
    model, gmodel = _r_models(bench_slice, dev, stage, cfg, plain)
    if stage == 1:
        return _train_steps(bench_slice, model, batch, noise[1], TRAIN_STEPS), model
    return _stage2_steps(bench_slice, model, gmodel, batch, noise[2], TRAIN_STEPS), model


def _r_noise(cfgs, batch, dev) -> dict:
    """Each stage's noise, as (G) and (I) draw it: stage 1's CVAE noise,
    stage 2's box jitter and frozen GSPN noise."""
    b = batch["xyz"].shape[0]
    from gspn_tpu_torch.utils.bench_slice import TRAIN_SEEDS

    eps = torch.randn((b, TRAIN_SEEDS, cfgs[1].latent_dim),
                      generator=torch.Generator().manual_seed(1)).to(dev)
    return {1: eps, 2: _stage2_draws(cfgs[2][0], b, 1, dev)}


def _r_expect(what, counts: dict, want) -> None:
    """Raise unless the nonzero launch ``counts`` are ``want``: these counts
    (a dict), or these kernels (a set)."""
    if (counts if isinstance(want, dict) else set(counts)) != want:
        raise AssertionError(f"{what} launched {counts}, expected {want}")


def _r_paths(label, ops, bench_slice, dev, cfgs, batch, per_step, total) -> dict:
    """Each stage of ``cfgs`` (``_r_configs``) on its kernel path, 1 +
    ``TRAIN_STEPS`` steps with exactly ``per_step[stage]`` launches a step
    (added to ``total``) and finite losses, then on its plain path, which
    launches nothing, bitwise the same (step 1's metrics and gradients,
    every loss, the parameters and running statistics). Returns each
    stage's kernel-path run."""
    noise = _r_noise(cfgs, batch, dev)
    runs = {}
    for stage in (1, 2):
        ops.reset_launch_counts()
        run, model = _r_run(bench_slice, dev, stage, cfgs[stage], batch, noise)
        counts = _nonzero(ops.launch_counts())
        _add_counts(total, counts)
        _r_expect(f"({label}) stage {stage}", counts,
                  {k: c * (TRAIN_STEPS + 1) for k, c in per_step[stage].items()})
        if not torch.isfinite(run[2]).all():
            raise AssertionError(f"({label}) stage {stage}: losses {run[2].tolist()}")
        before = ops.launch_counts()
        prun, pmodel = _r_run(bench_slice, dev, stage, cfgs[stage], batch, noise, plain=True)
        if ops.launch_counts() != before:
            raise AssertionError(f"({label}) stage {stage}: the plain path launched kernels")
        _q_same(f"({label}) stage {stage} kernel path vs plain path", run, prun, model, pmodel)
        print(f"slice ({label}) stage {stage}: kernel path == plain path bitwise over 1 + "
              f"{TRAIN_STEPS} steps (step-1 metrics and gradients, losses, parameters, running "
              f"statistics); launches {json.dumps(counts)}; step 1 "
              f"{', '.join(f'{k} {v.item():.6f}' for k, v in run[0].items())}; losses "
              f"{[round(x, 4) for x in run[2].tolist()]}")
        runs[stage] = run
    return runs


class _Recorder:
    """Records the calls of a module's function (or a class's static
    method) while in its ``with`` block: ``calls`` gets ``what(*args,
    **kwargs)`` for each."""

    def __init__(self, owner, name: str, what):
        self.owner, self.name, self.what, self.calls = owner, name, what, []

    def __enter__(self):
        import inspect

        self.raw = inspect.getattr_static(self.owner, self.name)
        real = getattr(self.owner, self.name)

        def recording(*args, **kwargs):
            self.calls.append(self.what(*args, **kwargs))
            return real(*args, **kwargs)

        static = isinstance(self.raw, staticmethod)
        setattr(self.owner, self.name, staticmethod(recording) if static else recording)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.raw)


def _r_bf16(ops, bench_slice, dev, batch, total) -> None:
    """(R-bf16): both stages in bfloat16 at full width, kernel against plain
    path; the bfloat16 gradients the gathers' backward sums on the card;
    the losses beside float32's from the same weights."""
    from gspn_tpu_torch.ops import grouping

    _phase("slice (R-bf16)")
    with _Recorder(grouping._GatherRows, "backward", lambda ctx, g: (
            str(g.dtype).split(".")[-1], g.shape[-1])) as grads:
        runs = _r_paths("R-bf16", ops, bench_slice, dev, _r_configs(bench_slice, "bf16"), batch,
                        {1: G_PER_STEP, 2: I_PER_STEP}, total)
    # the gathers' backward over both stages' kernel and plain paths, a step
    per = collections.Counter(grads.calls)
    steps = 2 * (TRAIN_STEPS + 1)
    if not any(dt == "bfloat16" for dt, _ in per):
        raise AssertionError(f"(R-bf16): no bfloat16 gradient reached a gather's backward: {per}")
    print("slice (R-bf16) the gathers' backward (index_add) a step of each stage, summed, by "
          "the gradient's dtype and channels: "
          + ", ".join(f"{dt} C {c}: {n / steps:g}" for (dt, c), n in per.items()))
    f32 = _r_configs(bench_slice)
    noise = _r_noise(f32, batch, dev)
    for stage in (1, 2):
        ops.reset_launch_counts()
        losses = _r_run(bench_slice, dev, stage, f32[stage], batch, noise)[0][2]
        _add_counts(total, _nonzero(ops.launch_counts()))
        gap = ((runs[stage][2] - losses).abs() / losses.abs()).tolist()
        print(f"slice (R-bf16) stage {stage}: bf16 against float32 on the same weights, batch and "
              f"noise, relative loss gap a step {[f'{g:.2e}' for g in gap]} (float32 losses "
              f"{[round(x, 4) for x in losses.tolist()]}; no bound asserted)")


def _r_wide(ops, bench_slice, dev, batch, total) -> None:
    """(R-wide): both stages at ``--width-mult 2`` in float32, kernel against
    plain path; stage 2's FP4 plan (staged) and the index_add launches of a
    step's backward, with their channels."""
    from gspn_tpu_torch.ops import grouping, interpolate

    _phase("slice (R-wide)")
    cfgs = _r_configs(bench_slice, width=2)
    fp_plans = _Recorder(interpolate, "_interp_mm_cuda", lambda points, idx, *a, **k: (
        tuple(idx.shape[:2]), points.shape[1], points.shape[2], interpolate.interp_mm_plan(
            idx.shape[0], idx.shape[1], points.shape[1], points.shape[2],
            0 if (len(a) < 2 or a[1] is None) else a[1].shape[-1],
            points.contiguous().data_ptr() % 16 == 0)))
    adds = _Recorder(grouping, "_index_add_cuda", lambda src, idx, n, *a, **k: (
        tuple(src.shape), n))
    with fp_plans, adds:
        _r_paths("R-wide", ops, bench_slice, dev, cfgs, batch, {1: G_PER_STEP, 2: I_PER_STEP},
                 total)
    # stage 1's kernel run, then stage 2's (the plain paths launch nothing):
    # a stage-2 step's FP levels and backward (SA2-SA4's gathers, FP1-FP4,
    # the RoIAlign) are the recorders' last
    rcfg, steps = cfgs[2][1], TRAIN_STEPS + 1
    n_fp, n_add = len(rcfg.fp_mlps), len(rcfg.sa_layers) + len(rcfg.fp_mlps)
    fp, step_adds = fp_plans.calls[-n_fp:], adds.calls[-n_add:]
    if (len(fp_plans.calls), len(adds.calls)) != (steps * n_fp, steps * (
            G_PER_STEP["index_add"] + n_add)):
        raise AssertionError(f"(R-wide): {len(fp_plans.calls)} interp_mm and {len(adds.calls)} "
                             "index_add launches recorded")
    (targets, m, c, plan), = [x for x in fp if x[0][1] == bench_slice.TRAIN_POINTS]
    if plan[2] == 0:
        raise AssertionError(f"(R-wide) stage 2 FP4 {targets} <- {m}, C {c}: plan {plan} is not "
                             "the staged form")
    print(f"slice (R-wide) stage 2 FP levels (targets <- sources, C: interp_mm_plan's rows x "
          f"slices x stage): " + "; ".join(f"{t[0]}x{t[1]} <- {mm}, C {cc}: "
                                           f"{'x'.join(map(str, p))}" for t, mm, cc, p in fp)
          + f"; FP4 (C {c}) takes the staged form")
    print("slice (R-wide) stage 2 backward, index_add launches a step ((B, positions, C) -> "
          "rows): " + "; ".join(f"{s} -> {n}" for s, n in step_adds))


def _r_step(bench_slice, stage, model, gmodel, batch, noise):
    """One Adam step (1e-3) of ``stage``'s loss as (G) and (I) take it, as a
    call."""
    from gspn_tpu_torch.train.steps import (
        TrainState, make_gspn_loss_fn, make_optimizer, make_rpointnet_loss_fn, make_train_step,
    )

    if stage == 1:
        loss_fn = make_gspn_loss_fn(bench_slice.TRAIN_SEEDS, bench_slice.TRAIN_GT)
        kw = {"z_eps": noise[1]}
    else:
        loss_fn = make_rpointnet_loss_fn(bench_slice.STAGE2_INSTANCES,
                                         (gmodel, bench_slice.TRAIN_SEEDS))
        kw = noise[2]
    step, state = make_train_step(loss_fn), TrainState(model, make_optimizer(model, 1e-3))
    return lambda: step(state, batch, **kw)


def _r_train(trainer, flags, log_dir, ops, total, want, steps=3):
    """``trainer.main(flags)`` for ``steps`` steps with a metric line each
    and a checkpoint at the end, its launches counted (added to ``total``):
    finite metrics, the checkpoint, exactly the kernels ``want``. Returns
    the train state."""
    name = trainer.__name__.split(".")[-1]
    state, counts = _counted(ops, lambda: trainer.main(flags + [
        "--steps", str(steps), "--log-every", "1", "--ckpt-every", str(steps),
        "--log-dir", log_dir]))
    _add_counts(total, counts)
    lines = _check_trainer(f"(R) {name} {' '.join(flags)}", state, log_dir, steps)
    _r_expect(f"(R) {name} {' '.join(flags)}", counts, set(want))
    print(f"slice (R) {name}.main {' '.join(flags)}: {steps} steps, {steps} finite metric "
          f"lines, checkpoint ckpt_{steps}.pt; losses {[round(r['loss'], 4) for r in lines]}; "
          f"launches {json.dumps(counts)}")
    return state


def _r_resume(trainer, flags, work, tag, ops, total) -> None:
    """``trainer.main(flags)`` 4 steps straight against 2 steps, a
    checkpoint and ``--resume`` for 2: parameters, running statistics, Adam
    moments and losses bitwise."""
    name = trainer.__name__.split(".")[-1]
    run = flags + ["--ckpt-every", "1", "--log-every", "1"]

    def both():
        straight = trainer.main(run + ["--steps", "4", "--log-dir", f"{work}/{tag}_a"])
        trainer.main(run + ["--steps", "2", "--log-dir", f"{work}/{tag}_b"])
        return straight, trainer.main(run + ["--steps", "4", "--resume",
                                             "--log-dir", f"{work}/{tag}_b"])

    (straight, resumed), counts = _counted(ops, both)
    _add_counts(total, counts)
    la, lb = (torch.tensor([r["loss"] for r in _jsonl_lines(f"{work}/{tag}_{x}")]) for x in "ab")
    _assert_same_training(f"(R) {name} {' '.join(flags)} 4 steps vs 2 + --resume 2",
                          straight.model, resumed.model, la, lb)
    oa, ob = (st.optimizer.state_dict()["state"] for st in (straight, resumed))
    if not all(torch.equal(oa[i][k].cpu(), ob[i][k].cpu()) for i in oa for k in oa[i]):
        raise AssertionError(f"(R) {name} {' '.join(flags)} --resume: Adam moments differ")
    print(f"slice (R) {name} {' '.join(flags)}: 4 steps straight == 2 steps, a checkpoint and "
          f"--resume for 2 (parameters, running statistics, Adam moments, losses bitwise); "
          f"losses {la.tolist()}")


def _r_entry_points(dev, ops, bench_slice, work, total) -> None:
    """Both trainers at their defaults with ``--width-mult 2 --dtype bf16``
    (and ``--resume``) and with ``--group-select strided``; ``run_eval`` on
    the wide bf16 checkpoints, its kernel path against its plain path, and
    ``--artifact`` on ``export_serving``'s export of them against the live
    summary."""
    from gspn_tpu_torch.eval import run_eval
    from gspn_tpu_torch.serve import export_serving
    from gspn_tpu_torch.train import train_gspn, train_rpointnet

    _phase("slice (R) trainers")
    wide = ["--width-mult", "2", "--dtype", "bf16"]
    gdir, rdir = f"{work}/r_gspn_wide", f"{work}/r_rpointnet_wide"
    state = _r_train(train_gspn, wide, gdir, ops, total, G_PER_STEP)
    want = _r_configs(bench_slice, "bf16", 2)[1]
    if state.model.config != want:
        raise AssertionError(f"(R) train_gspn {' '.join(wide)}: config {state.model.config}, "
                             f"expected {want}")
    _r_resume(train_gspn, wide, work, "r_gspn_resume", ops, total)
    gwide = ["--gspn-ckpt", f"{gdir}/ckpt"] + wide
    state = _r_train(train_rpointnet, gwide, rdir, ops, total, I_PER_STEP)
    if state.model.config.dtype != torch.bfloat16:
        raise AssertionError(f"(R) train_rpointnet {' '.join(wide)}: {state.model.config}")
    _r_resume(train_rpointnet, gwide, work, "r_rpointnet_resume", ops, total)
    strided = ["--group-select", "strided"]
    _r_train(train_gspn, strided, f"{work}/r_gspn_strided", ops, total, R_STRIDED_G)
    _r_train(train_rpointnet, strided + ["--gspn-ckpt", f"{work}/r_gspn_strided/ckpt"],
             f"{work}/r_rpointnet_strided", ops, total, R_STRIDED_I)

    _phase("slice (R) run_eval --width-mult 2 --dtype bf16")
    argv = ["--gspn-ckpt", f"{gdir}/ckpt", "--rpointnet-ckpt", f"{rdir}/ckpt", *wide,
            "--score-thresh", "0"]
    live, counts = _counted(ops, lambda: _eval_main(run_eval, argv))
    _add_counts(total, counts)
    _r_expect(f"(R) run_eval {' '.join(argv)}", counts, SLICE_KERNELS["K"])
    seen, counts = _counted(ops, lambda: _eval_paths_agree(run_eval, bench_slice, ops, argv, dev,
                                                           "(R)"))
    _add_counts(total, counts)
    print(f"slice (R) run_eval {' '.join(wide)} --score-thresh 0: kernel path == plain path "
          f"batch by batch (masks, valid, classes equal; scores, boxes within rtol 1e-4 atol "
          f"1e-5); the plain path launched nothing; {json.dumps(seen)}")
    art, counts = _counted(ops, lambda: export_serving.main([
        "--batch", "4", "--num-points", "4096", "--gspn-ckpt", f"{gdir}/ckpt",
        "--rpointnet-ckpt", f"{rdir}/ckpt", *wide, "--verify", "--score-thresh", "0",
        "--out", f"{work}/r_wide.gspnt"]))
    _add_counts(total, counts)
    served, counts = _counted(ops, lambda: _eval_main(run_eval, argv + ["--artifact", str(art)]))
    _add_counts(total, counts)
    if _rate_aside(served) != _rate_aside(live):
        raise AssertionError(f"(R) run_eval --artifact: summary {served}, live {live}")
    print(f"slice (R) export_serving {' '.join(wide)} at B=4 x N=4096, then run_eval "
          f"--artifact on it: the live run's summary bit for bit: {_rate_aside(live)}")


def _r_width_study(dev, ops, bench_slice, card, batch, total) -> None:
    """Host ms a step of each stage on the kernel path, float32 and bf16 at
    ``--width-mult`` 1, 2 and 4 (median, min-max of ``TRAIN_STEPS`` after
    a warm-up), and at 2 a ``torch.profiler`` window of each dtype: wall and
    device busy ms, idle share and device operations a step."""
    _phase("slice (R) width study")
    noise = _r_noise(_r_configs(bench_slice), batch, dev)
    table, windows = {}, {}
    for stage in (1, 2):
        for width in R_WIDTHS:
            for knob in ("f32", "bf16"):
                cfg = _r_configs(bench_slice, knob, width)[stage]
                step = _r_step(bench_slice, stage, *_r_models(bench_slice, dev, stage, cfg),
                               batch, noise)
                ops.reset_launch_counts()
                table[stage, width, knob] = _times(step, TRAIN_STEPS)
                if width == 2:
                    windows[stage, knob] = _profile_window(step, R_WINDOW_STEPS)
                _add_counts(total, _nonzero(ops.launch_counts()))
    print(f"slice (R) width study, host ms a training step (B={bench_slice.TRAIN_BATCH} x "
          f"N={bench_slice.TRAIN_POINTS}, Adam; median (min-max) of {TRAIN_STEPS} after a "
          f"warm-up) [{card}]:")
    for stage in (1, 2):
        for width in R_WIDTHS:
            f32, bf16 = table[stage, width, "f32"], table[stage, width, "bf16"]
            print(f"  stage {stage} x{width}: f32 {_span(f32)}, bf16 {_span(bf16)}, bf16 / f32 "
                  f"{statistics.median(bf16) / statistics.median(f32):.3f}")
    for (stage, knob), (wall, busy, idle, n_ops) in windows.items():
        print(f"slice (R) stage {stage} x2 {knob} under torch.profiler ({R_WINDOW_STEPS} steps "
              f"after a warm-up): wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
              f"{idle:.3f}, {n_ops:g} device operations a step [{card}]")


def run_train_knobs_slice(dev, ops, bench_slice, card, work) -> dict:
    """Slice (R): the trainers' knobs at full width on (G)'s batch (B=4 x
    N=4096), seeded weights, TF32 off. (R-bf16) both stages in bfloat16
    (``train_gspn --dtype bf16``; ``bench_slice.stage2_configs()`` with both
    stages bf16, as ``train_rpointnet --dtype bf16``); (R-strided) both
    with ``group_select="strided"`` (stage 2's frozen GSPN too); (R-wide)
    both at ``--width-mult 2`` in float32: each 1 + ``TRAIN_STEPS`` steps
    on its kernel path, with exactly its launches a step, bitwise its plain
    path. Then the entry points: ``train_gspn`` and ``train_rpointnet
    --gspn-ckpt`` with ``--width-mult 2 --dtype bf16`` (3 steps; 4 against
    2 + ``--resume`` 2, bitwise) and with ``--group-select strided`` (3
    steps); ``run_eval`` on the wide bf16 checkpoints (kernel path against
    plain path, ``--artifact`` of ``export_serving``'s export against the
    live summary); and the width study. Returns the slice's launches."""
    _phase("slice (R)")
    t0 = time.perf_counter()
    total = {}
    batch = bench_slice.train_batch(dev)
    _r_bf16(ops, bench_slice, dev, batch, total)
    _phase("slice (R-strided)")
    _r_paths("R-strided", ops, bench_slice, dev, _r_configs(bench_slice, "strided"), batch,
             {1: R_STRIDED_G, 2: R_STRIDED_I}, total)
    _r_wide(ops, bench_slice, dev, batch, total)
    _r_entry_points(dev, ops, bench_slice, work, total)
    _r_width_study(dev, ops, bench_slice, card, batch, total)
    _r_expect("slice (R)", total, SLICE_KERNELS["R"])
    print(f"slice (R) launches: {json.dumps(total)}; {time.perf_counter() - t0:.1f} s [{card}]")
    return {k: total.get(k, 0) for k in ops.launch_counts()}


# the JAX eval's summary keys with --bootstrap and an --ab-* arm
EVAL_AB_KEYS = {"scenes", "ap", "ap_50", "ap_25", "points_per_sec", "ap_ci95", "ap_50_ci95",
                "ap_25_ci95", "ap_armB", "ap_50_armB", "ap_25_armB", "ap_diff", "ap_diff_mean",
                "ap_50_diff", "ap_50_diff_mean", "ap_25_diff", "ap_25_diff_mean"}
# the flagship knobs the paired arms run on, and the arms
EVAL_FLAGSHIP = ["--fps-segments", "8", "--fps-segment-mode", "spatial",
                 "--mask-project-prune", "auto"]
EVAL_ARMS = (["--ab-fps-segments", "1"], ["--ab-sa1-fps-segments", "32"],
             ["--ab-group-select", "strided"])
# the eval's rate: runs of the loop over this many scenes (batches 2-16 timed)
EVAL_RATE_SCENES, EVAL_RATE_RUNS = 64, 5


def _eval_main(run_eval, argv) -> dict:
    """``run_eval.main(argv)``: its output printed, its summary line
    returned."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_eval.main(argv)
    out = buf.getvalue().strip()
    print("\n".join(f"  run_eval: {line}" for line in out.splitlines()))
    return json.loads(out.splitlines()[-1])


def _rate_aside(summary: dict) -> str:
    """The summary without its points a second, as JSON (NaN equal to NaN)."""
    return json.dumps({k: v for k, v in summary.items() if k != "points_per_sec"},
                      sort_keys=True)


def _eval_weights(run_eval, args, dev):
    """``(cfg, state, z_eps)`` as ``run_eval.main`` builds them from
    ``args``: the config (at the data's feature width), the first weights
    with the checkpoints restored,
    and the one noise draw every batch takes (on ``dev``)."""
    from gspn_tpu_torch.models.pipeline import init_pipeline_variables
    from gspn_tpu_torch.serve.runtime import chunk_noise, restore_checkpoints

    cfg = run_eval.build_config(args)
    first = next(iter(run_eval.scene_batches(args)()))
    cfg = run_eval.with_feature_dim(cfg, run_eval.batch_feature_dim(first))  # the data's width
    state = init_pipeline_variables(cfg, torch.Generator().manual_seed(args.seed),
                                    args.num_points)
    restore_checkpoints(state, args.gspn_ckpt, args.rpointnet_ckpt)
    z_eps = chunk_noise(args.seed, 0, (args.batch, cfg.num_seeds, cfg.gspn.latent_dim))
    return cfg, state, z_eps.to(dev)


def _eval_paths_agree(run_eval, bench_slice, ops, argv, dev, label: str = "(K)") -> dict:
    """The evaluation loop on ``argv``'s config, with its ``--ab-*`` arm as
    ``infer_b`` when it has one, through the kernel path and through the
    plain path (``bench_slice.plain_config`` of each arm) on the same
    scenes, weights and noise, every batch's predictions recorded. Raises
    if the plain path launched a kernel, unless in each arm every batch's
    masks, valid and classes are equal and its scores and boxes agree
    within rtol 1e-4 atol 1e-5, and unless each arm's masks of valid
    instances hold some but not all of the points at the eval's mask
    threshold. Returns each arm's batches, valid instances and mask share."""
    args = run_eval.parse_args(argv)
    cfg, state, z_eps = _eval_weights(run_eval, args, dev)
    arms = {"A": cfg, "B": run_eval.ab_config(cfg, args)}
    if arms["B"] is None:
        del arms["B"]
    outs = {}

    def recording(c, key):
        infer = run_eval.live_infer(c, state, dev)
        outs[key] = []

        def call(xyz, valid, eps, **kw):
            outs[key].append(infer(xyz, valid, eps, **kw))
            return outs[key][-1]
        return call

    for path, config_of in (("kernel", lambda c: c), ("plain", bench_slice.plain_config)):
        infers = [recording(config_of(c), (path, arm)) for arm, c in arms.items()]
        before = ops.launch_counts()
        run_eval.evaluate(infers[0], run_eval.scene_batches(args)(), z_eps, *infers[1:])
        if path == "plain" and ops.launch_counts() != before:
            raise AssertionError(f"slice {label} {argv}: the plain path launched kernels")
    seen = {}
    for arm in arms:
        kernel, plain = outs["kernel", arm], outs["plain", arm]
        for i, (got, want) in enumerate(zip(kernel, plain, strict=True)):
            for f in ("masks", "valid", "classes"):
                if not torch.equal(getattr(got, f), getattr(want, f)):
                    raise AssertionError(f"slice {label} {argv} arm {arm} batch {i}: kernel and "
                                         f"plain paths differ in {f}")
            for f in ("scores", "boxes"):
                torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=1e-4,
                                           atol=1e-5)
        share = torch.cat([o.masks[o.valid] for o in kernel]).float().mean().item()
        if not 0.0 < share < 1.0:
            raise AssertionError(f"slice {label} {argv} arm {arm}: masks of valid instances hold "
                                 f"{share} of the points at mask_thresh {cfg.mask_thresh}")
        seen[arm] = {"batches": len(kernel), "valid": sum(int(o.valid.sum()) for o in kernel),
                     "mask_share": round(share, 4)}
    return seen


def run_eval_slice(dev, ops, bench_slice, card, work):
    """Slice (K): ``run_eval`` on the card at its defaults (``GSPNConfig()``
    and ``RPointNetConfig(num_classes=18)``, 64 seeds, 16 scenes of B=4 x
    N=4096) with the checkpoints (G) and (I) wrote under ``work``: the
    default run with ``--bootstrap 100`` and npz dumps (the launch counts
    set to 0 just before: exactly (A)'s kernels grow); at ``--score-thresh
    0``, where the proposals of these briefly trained weights survive, the
    live run, a second run with ScanNet dumps (the summary bit for bit, read
    back as the npz dumps) and ``--artifact`` (an export of the eval's
    config for cuda at B=4 x N=4096: summary and every dump bit for bit);
    the paired arms on the flagship knobs; the evaluation loop's kernel path
    against its plain path, batch by batch, in both arms of each of those
    configs; and the eval's points/s, live and from the artifact, over
    ``EVAL_RATE_RUNS`` runs of ``EVAL_RATE_SCENES`` scenes. Returns the
    default run's launch counts."""
    from gspn_tpu_torch.eval import run_eval
    from gspn_tpu_torch.eval.scannet_export import read_scannet_submission
    from gspn_tpu_torch.serve import export_serving

    _phase("slice (K)")
    gspn_ckpt = str(pathlib.Path(work, "gspn", "ckpt"))
    rpn_ckpt = str(pathlib.Path(work, "rpointnet--gspn-ckpt", "ckpt"))
    ckpts = ["--gspn-ckpt", gspn_ckpt, "--rpointnet-ckpt", rpn_ckpt, "--bootstrap", "100"]
    ops.reset_launch_counts()
    live = _eval_main(run_eval, ckpts + ["--dump-dir", f"{work}/eval_npz"])
    counts = ops.launch_counts()
    print(f"slice (K) launches: {json.dumps(counts)}")
    launched = {k for k, c in counts.items() if c}
    if launched != SLICE_KERNELS["K"]:
        raise AssertionError(f"slice (K) launched {sorted(launched)}, "
                             f"expected {sorted(SLICE_KERNELS['K'])}")
    if len(list(pathlib.Path(work, "eval_npz").glob("*.npz"))) != live["scenes"]:
        raise AssertionError("slice (K): the default run did not dump every scene")

    _phase("slice (K) --artifact")
    # the trained 3 + 3 steps score every proposal below the default 0.05: the
    # runs compared keep them all (an artifact carries the score threshold it
    # was exported with)
    keep_all = ckpts + ["--score-thresh", "0"]
    art = export_serving.main(["--batch", "4", "--num-points", "4096", "--gspn-ckpt", gspn_ckpt,
                               "--rpointnet-ckpt", rpn_ckpt, "--verify", "--score-thresh", "0",
                               "--out", f"{work}/eval.gspnt"])
    live0 = _eval_main(run_eval, keep_all + ["--dump-dir", f"{work}/eval_live"])
    again = _eval_main(run_eval, keep_all + ["--dump-dir", f"{work}/eval_scannet",
                                             "--dump-format", "scannet"])
    served = _eval_main(run_eval, keep_all + ["--artifact", str(art), "--dump-dir",
                                              f"{work}/eval_served"])
    if _rate_aside(again) != _rate_aside(live0):
        raise AssertionError(f"slice (K): a second run's summary {again} differs from {live0}")
    if _rate_aside(served) != _rate_aside(live0):
        raise AssertionError(f"slice (K): --artifact's summary {served} differs from {live0}")
    dumps = sorted(pathlib.Path(work, "eval_live").glob("*.npz"))
    if len(dumps) != live0["scenes"]:
        raise AssertionError(f"slice (K): {len(dumps)} npz dumps for {live0['scenes']} scenes")
    kept = 0
    for dump in dumps:
        back = read_scannet_submission(f"{work}/eval_scannet", dump.stem)
        with np.load(dump) as z, np.load(pathlib.Path(work, "eval_served", dump.name)) as a:
            if not all(np.array_equal(z[k], a[k]) for k in z.files):
                raise AssertionError(f"slice (K) {dump.stem}: --artifact's dump differs")
            if not (np.array_equal(back.masks, z["masks"]) and np.array_equal(
                    back.classes, z["classes"]) and np.allclose(back.scores, z["scores"],
                                                                 rtol=0, atol=1e-6)):
                raise AssertionError(f"slice (K) {dump.stem}: the ScanNet dump reads back "
                                     "other predictions than the npz dump")
            kept += z["masks"].shape[0]
    if not kept:
        raise AssertionError("slice (K) --score-thresh 0: no prediction to compare")
    print(f"slice (K) --score-thresh 0: a second run and --artifact (a CUDA graph replay a "
          f"batch) == the live run: the summary (bitwise), every scene's dump ({kept} "
          f"predictions, bitwise); the ScanNet dumps read back as the npz dumps")

    _phase("slice (K) paired arms")
    fps_by_arm = {}
    for arm in EVAL_ARMS:
        ops.reset_launch_counts()
        summary = _eval_main(run_eval, keep_all + EVAL_FLAGSHIP + arm)
        got = ops.launch_counts()
        if set(summary) != EVAL_AB_KEYS:
            raise AssertionError(f"slice (K) {arm}: summary keys {sorted(summary)}")
        must = {"mask_project_boxed"} | (
            {"ball_group_strided", "box_group_strided"} if "strided" in arm else set())
        if not all(got[k] for k in must):
            raise AssertionError(f"slice (K) {arm}: launches {got}, none of one of {must}")
        fps_by_arm[arm[0]] = got["fps"]
        launched = {k: c for k, c in got.items() if c}
        print(f"slice (K) {' '.join(arm)}: launches {json.dumps(launched)}")
    batches = live["scenes"] // 4
    if fps_by_arm["--ab-sa1-fps-segments"] != fps_by_arm["--ab-fps-segments"] + batches:
        raise AssertionError(f"slice (K): fps launches {fps_by_arm}: arm B's sa1 pass should add "
                             f"one a batch ({batches})")
    print(f"slice (K): the sa1 arm launches fps once more a batch ({fps_by_arm})")

    _phase("slice (K) kernel path vs plain path")
    for extra in ([], *(EVAL_FLAGSHIP + arm for arm in EVAL_ARMS)):
        seen = _eval_paths_agree(run_eval, bench_slice, ops, keep_all + extra, dev)
        print(f"slice (K) {' '.join(extra) or 'defaults'}, score_thresh 0: kernel path == plain "
              f"path in each arm (masks, valid, classes equal; scores, boxes within rtol 1e-4 "
              f"atol 1e-5); the plain path launched nothing; {json.dumps(seen)}")

    _phase("slice (K) points/s")
    args = run_eval.parse_args(keep_all + ["--num-scenes", str(EVAL_RATE_SCENES)])
    cfg, state, z_eps = _eval_weights(run_eval, args, dev)
    scenes = list(run_eval.scene_batches(args)())
    infers = {"live": run_eval.live_infer(cfg, state, dev),
              "artifact": run_eval.artifact_infer(str(art), cfg, state, args, dev)}
    rates = {name: [] for name in infers}
    for _ in range(EVAL_RATE_RUNS):
        for name, infer in infers.items():
            rates[name].append(run_eval.evaluate(infer, scenes, z_eps).points_per_sec)
    plain = run_eval.evaluate(run_eval.live_infer(bench_slice.plain_config(cfg), state, dev),
                              scenes, z_eps).points_per_sec
    timed = f"batches 2-{len(scenes)} of B=4 x N=4096, --score-thresh 0"
    for name, got in rates.items():
        print(f"slice (K) {name}: median {statistics.median(got)} points/s, min-max "
              f"{min(got)}-{max(got)} over {EVAL_RATE_RUNS} runs ({timed}) [{card}]")
    print(f"slice (K) plain path: {plain} points/s over 1 run ({timed}) [{card}]")
    print(f"slice (K) summary at the defaults: {json.dumps(live)}; at --score-thresh 0: "
          f"{json.dumps(live0)}")
    return counts


def _rgb_request(cfg, bench_slice, dev):
    """(L)'s flagship request with features: the synthetic scenes with RGB
    (``scene_batch(default_rng(0), 8, n_points=8192, feature_dim=3)``),
    the flagship request's noise."""
    from gspn_tpu_torch.data import synthetic

    sb = synthetic.scene_batch(np.random.default_rng(0), B, n_points=N, max_instances=8,
                               feature_dim=FDIM)
    eps = bench_slice.request(cfg, FLAGSHIP, dev, 1)[2]
    return tuple(torch.from_numpy(sb[k]).to(dev) for k in ("xyz", "valid")) + (
        eps, torch.from_numpy(sb["features"]).to(dev))


def run_knob_slice(dev, ops, bench_slice, card, work, a_counts):
    """Slice (L): the knob paths at full width. (L-bf16) ``set_pipeline_dtype(
    slice_config(), bfloat16)`` on (A)'s weights at both shapes: the kernel
    path against the bf16 plain path as every slice, the launches a request
    (A)'s, and against the float32 kernel path on the same weights within
    ``tests/test_bf16.py``'s bounds (boxes rtol/atol 0.1, scores 0.25), the
    share of mask cells that differ printed, host ms a request of both.
    (L-rgb) ``slice_config(feature_dim=3)`` on the flagship scenes with RGB:
    kernel path against plain path, FP4's interp_mm launched with the RGB
    skip (C1 = 3). One export and replay (``InferenceSession``, a CUDA
    graph) each of (L-bf16) and (L-rgb) at the flagship, bitwise the live
    kernel path. (L-object) ``train_gspn --preset object
    --synthetic-objects --num-points 4096``'s model and first batch: 1 +
    ``OBJECT_STEPS`` steps a path, exactly (G)'s kernels once a step (the
    ball group at one radius with K = 4096), the kernel path bitwise the
    plain path (step 1's loss, terms and gradients, every loss, the
    parameters and running statistics), host ms a step; then
    ``train_gspn.main`` with those flags for 3 steps. Returns each
    sub-slice's launch counts."""
    from gspn_tpu_torch.data.iterator import DeterministicBatches, to_device
    from gspn_tpu_torch.models.pipeline import PREDICTION_FIELDS, make_inference_fn
    from gspn_tpu_torch.models.presets import set_pipeline_dtype
    from gspn_tpu_torch.ops import interpolate as tinterp
    from gspn_tpu_torch.serve import InferenceSession, export_inference, save_artifact
    from gspn_tpu_torch.serve.export import serving_state
    from gspn_tpu_torch.train import train_gspn

    runs = {}
    a_request = {k: c / (2 * (REQUESTS + 1)) for k, c in a_counts.items()}
    cfg = bench_slice.slice_config()
    model = bench_slice.seeded_model(cfg, dev)
    reqs = {shape: bench_slice.request(cfg, shape, dev, seed)
            for seed, shape in enumerate((FLAGSHIP, WHOLE_SCENE), start=1)}
    with torch.inference_mode():
        bcfg = set_pipeline_dtype(cfg, torch.bfloat16)
        bmodel = bench_slice.rebuilt_model(bcfg, model)
        bf16, _, runs["L-bf16"] = run_slice("L-bf16", ops, bench_slice, bcfg, bmodel, reqs,
                                            VARIANT_REQUESTS)
        per = {k: c / (2 * (VARIANT_REQUESTS + 1)) for k, c in runs["L-bf16"].items()}
        if per != a_request:
            raise AssertionError(f"(L-bf16) launches a request {per}, (A)'s {a_request}")
        infer = make_inference_fn(cfg)
        for shape, req in reqs.items():
            f32_times, f32 = _timed_requests(infer, model, req, VARIANT_REQUESTS)
            times, got = bf16[shape]
            torch.testing.assert_close(got.boxes, f32.boxes, rtol=0.1, atol=0.1)
            gap = (got.scores - f32.scores).abs().max().item()
            if gap >= 0.25:
                raise AssertionError(f"(L-bf16) {shape}: scores {gap} from float32's")
            differ = (got.masks != f32.masks).float().mean().item()
            box_gap = (got.boxes - f32.boxes).abs().max().item()
            print(f"slice (L-bf16) {shape}: bf16 vs float32 kernel path on the same weights: "
                  f"boxes within rtol/atol 0.1 (max abs gap {box_gap:.4f}), scores within "
                  f"{gap:.4f}, mask cells that differ "
                  f"{differ:.6f}, valid that differ {(got.valid != f32.valid).sum().item()}; "
                  f"host ms a request bf16 median {statistics.median(times):.3f}, float32 "
                  f"{statistics.median(f32_times):.3f} ({VARIANT_REQUESTS} requests after a "
                  f"warm-up each) [{card}]")
            xyz, valid, eps = req[:3]
            binfer = make_inference_fn(bcfg)
            n_bf16 = _device_ops(lambda: binfer(bmodel, xyz, valid, z_eps=eps))
            n_f32 = _device_ops(lambda: infer(model, xyz, valid, z_eps=eps))
            print(f"slice (L-bf16) {shape}: device operations a request (kernels, copies, "
                  f"fills; torch.profiler, the most of 3 one-request windows) bf16 {n_bf16}, "
                  f"float32 {n_f32}, {n_bf16 - n_f32:+d} [{card}]")

        fcfg = bench_slice.slice_config(feature_dim=FDIM)
        fmodel = bench_slice.seeded_model(fcfg, dev)
        freq = {FLAGSHIP: _rgb_request(fcfg, bench_slice, dev)}
        skips, direct = [], tinterp._interp_mm_cuda

        def recording(points, idx, wd, skip=None, **kw):  # the FP levels' skip widths
            skips.append(0 if skip is None else skip.shape[-1])
            return direct(points, idx, wd, skip, **kw)

        tinterp._interp_mm_cuda = recording
        try:
            _, _, runs["L-rgb"] = run_slice("L-rgb", ops, bench_slice, fcfg, fmodel, freq,
                                            VARIANT_REQUESTS)
        finally:
            tinterp._interp_mm_cuda = direct
        per = {k: c / (VARIANT_REQUESTS + 1) for k, c in runs["L-rgb"].items()}
        if per != a_request or skips.count(FDIM) != VARIANT_REQUESTS + 1:
            raise AssertionError(f"(L-rgb) launches a request {per} ((A)'s {a_request}), "
                                 f"interp_mm skip widths {sorted(set(skips))}")
        print(f"slice (L-rgb): FP4's interp_mm launched with the RGB skip (C1 = {FDIM}) once "
              f"a request; skip widths {sorted(set(skips))}")

        for name, ecfg, emodel, req in (("L-bf16", bcfg, bmodel, reqs[FLAGSHIP]),
                                        ("L-rgb", fcfg, fmodel, freq[FLAGSHIP])):
            t0 = time.perf_counter()
            program = export_inference(ecfg, emodel, N, batch_size=B, device=dev)
            path = save_artifact(pathlib.Path(work) / f"{name}.gspnt", program, ecfg)
            session = InferenceSession(path, serving_state(emodel), device=dev)
            secs = time.perf_counter() - t0
            xyz, valid, eps, *feats = req
            live = make_inference_fn(ecfg)(emodel, xyz, valid, z_eps=eps,
                                           features=feats[0] if feats else None)
            got = session.run(xyz, valid, eps, *feats)
            for f, g in zip(PREDICTION_FIELDS, got, strict=True):
                if not torch.equal(g, getattr(live, f)):
                    raise AssertionError(f"({name}) the artifact's replay differs in {f}")
            times = [_host_ms(lambda: session.run(xyz, valid, eps, *feats))[0]
                     for _ in range(VARIANT_REQUESTS)]
            print(f"slice ({name}) export: exported, written, loaded and captured in "
                  f"{secs:.1f} s; InferenceSession.run (graph replay) == the live kernel path "
                  f"bitwise; replay host ms median {statistics.median(times):.3f} "
                  f"({VARIANT_REQUESTS} requests) [{card}]")

    _phase("slice (L-object)")
    flags = ["--preset", "object", "--synthetic-objects", "--num-points", str(OBJECT_N)]
    args = train_gspn.parse_args(flags)
    first = DeterministicBatches(train_gspn.make_sample_fn(args), args.batch, args.seed
                                 ).batch_at(0)
    ocfg = train_gspn.model_config(args, first)
    if ocfg.context_nsample != (OBJECT_N,) or ocfg.context_radii != (2.0,):
        raise AssertionError(f"(L-object) config {ocfg}")
    batch = to_device(first, dev)
    omodel = bench_slice.seeded_gspn(ocfg, dev)
    _, pmodel = bench_slice.plain_gspn(ocfg, omodel)
    eps = torch.randn((args.batch, args.num_seeds, ocfg.latent_dim),
                      generator=torch.Generator().manual_seed(1)).to(dev)
    ops.reset_launch_counts()
    ofirst, ograds, losses, times = _train_steps(bench_slice, omodel, batch, eps, OBJECT_STEPS)
    runs["L-object"] = ops.launch_counts()
    want = {k: c * (OBJECT_STEPS + 1) for k, c in OBJECT_PER_STEP.items()}
    if {k: c for k, c in runs["L-object"].items() if c} != want:
        raise AssertionError(f"(L-object) launched {runs['L-object']}, expected {want}")
    before = ops.launch_counts()
    pfirst, pgrads, plosses, ptimes = _train_steps(bench_slice, pmodel, batch, eps, OBJECT_STEPS)
    if ops.launch_counts() != before:
        raise AssertionError("(L-object): the plain path launched kernels")
    if not torch.isfinite(losses).all():
        raise AssertionError(f"(L-object): non-finite losses {losses.tolist()}")
    for k in ofirst:
        if not torch.equal(ofirst[k], pfirst[k]):
            raise AssertionError(f"(L-object) step 1 {k}: {ofirst[k].item()} vs "
                                 f"{pfirst[k].item()}")
    differ = [k for k in ograds if not torch.equal(ograds[k], pgrads[k])]
    if differ:
        raise AssertionError(f"(L-object): step-1 gradients differ in {differ[:3]}")
    _assert_same_training("(L-object) kernel path vs plain path", omodel, pmodel, losses,
                          plosses)
    print(f"slice (L-object) {args.batch} objects x {OBJECT_N} points, {args.num_seeds} seeds, "
          f"one crop of K = {OBJECT_N}: kernel path == plain path bitwise over 1 + "
          f"{OBJECT_STEPS} steps (losses, step-1 gradients, parameters, running statistics); "
          f"losses {[round(x, 4) for x in losses.tolist()]}; host ms a step kernel median "
          f"{statistics.median(times):.3f}, plain {statistics.median(ptimes):.3f} [{card}]")
    with tempfile.TemporaryDirectory() as tmp:
        state = train_gspn.main(flags + ["--steps", "3", "--log-every", "1", "--ckpt-every", "3",
                                         "--log-dir", tmp])
        lines = [json.loads(x) for x in pathlib.Path(tmp, "train.jsonl").read_text().splitlines()]
    if state.step != 3 or len(lines) != 3 or not all(
            np.isfinite(v) for rec in lines for v in rec.values()):
        raise AssertionError(f"train_gspn {' '.join(flags)}: step {state.step}, {lines}")
    print(f"slice (L-object) train_gspn.main {' '.join(flags)}: 3 steps, 3 finite metric lines; "
          f"last loss {lines[-1]['loss']:.4f}")
    return runs


# slice (M): real-layout files. ScanNet scans the size of a _vh_clean_2.ply
# room on a floor larger than the 3 m block crop, a ShapeNet-style h5
# (objects x points, categories) and a PartNet-style h5 (shapes x points)
M_SCANS, M_VERTICES, M_FLOOR, M_CELL = 4, 150_000, 8.0, 0.25
M_SHAPENET, M_PARTNET = (64, 2048, 2), (32, 10_000)
M_BATCHES, M_STEPS, M_SCENES = 10, 3, 8  # host-timed batches; trainer steps; eval scenes
# aggregation labels: benchmark nyu40 names, and two outside the benchmark
M_LABELS = ("cabinet", "bed", "chair", "sofa", "table", "door", "window", "bookshelf",
            "picture", "counter", "desk", "curtain", "refrigerator", "toilet", "sink",
            "bathtub", "otherfurniture", "wall", "floor")
# slice (N): ranks on the one card, and timed steps after a warm-up; the
# DP step's largest gap from the single-process step, relative to each
# tensor's largest change (``_state_close``)
N_RANKS, N_STEPS, DP_GRAD_RTOL = 2, 5, 2e-2
# slice (O): ranks on the one card, timed requests and steps after a
# warm-up, and the share of mask cells a sharded request may flip against
# the single-process one (the bound the mm-against-exact interpolation has)
O_RANKS, O_REQUESTS, O_STEPS, O_MASK_SHARE = 4, 3, 3, 1e-3


def _write_scan(root: pathlib.Path, scene_id: str, rng) -> None:
    """A scan in the ScanNet release layout: ``M_VERTICES`` vertices with RGB
    on an ``M_FLOOR`` m square (a binary little-endian PLY with an empty face
    element), over-segments of ``M_CELL`` m cells (``segs.json``), and 3-12
    instances, each the cells within 1-3 cells of a centre, labelled with
    ``M_LABELS`` names (``aggregation.json``)."""
    scan = root / scene_id
    scan.mkdir(parents=True)
    n = M_VERTICES
    xyz = np.concatenate([rng.uniform(0, M_FLOOR, (n, 2)), rng.uniform(0, 2.5, (n, 1))],
                         1).astype(np.float32)
    dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                   ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    arr = np.empty(n, dt)
    arr["x"], arr["y"], arr["z"] = xyz.T
    for c in ("red", "green", "blue"):
        arr[c] = rng.integers(0, 256, n)
    with open(scan / f"{scene_id}_vh_clean_2.ply", "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\nelement vertex {n}\n"
                 "property float x\nproperty float y\nproperty float z\nproperty uchar red\n"
                 "property uchar green\nproperty uchar blue\nelement face 0\n"
                 "property list uchar int vertex_indices\nend_header\n").encode())
        f.write(arr.tobytes())
    side = int(M_FLOOR / M_CELL)
    cx, cy = (np.minimum(xyz[:, d] // M_CELL, side - 1).astype(np.int64) for d in (0, 1))
    (scan / f"{scene_id}_vh_clean_2.0.010000.segs.json").write_text(
        json.dumps({"segIndices": (cx * side + cy).tolist()}))
    gx, gy = np.divmod(np.arange(side * side), side)
    groups = []
    for _ in range(int(rng.integers(3, 13))):
        ox, oy, r = rng.integers(0, side), rng.integers(0, side), rng.integers(1, 4)
        cells = np.flatnonzero((np.abs(gx - ox) <= r) & (np.abs(gy - oy) <= r))
        groups.append({"label": M_LABELS[int(rng.integers(0, len(M_LABELS)))],
                       "segments": cells.tolist()})
    (scan / f"{scene_id}.aggregation.json").write_text(json.dumps({"segGroups": groups}))


class _NpzH5File:
    """The part of ``h5py.File`` that the h5 loaders and (M)'s writers use
    (``create_dataset``, ``[name]``, ``in``, ``keys``, a context), over an
    ``.npz`` archive: (M)'s stand-in where ``h5py`` is not installed."""

    def __init__(self, path, mode: str = "r"):
        self._path, self._mode = pathlib.Path(path), mode
        self._data = {}
        if mode == "r":
            with np.load(self._path) as z:
                self._data = {k: z[k] for k in z.files}

    def create_dataset(self, name, data):
        self._data[name] = np.asarray(data)

    def __getitem__(self, name):
        return self._data[name]

    def __contains__(self, name):
        return name in self._data

    def keys(self):
        return self._data.keys()

    def close(self):
        if self._mode == "w":
            with open(self._path, "wb") as f:
                np.savez(f, **self._data)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _h5_module():
    """``(module, note)``: ``h5py`` where it is installed, else a module
    whose ``File`` is ``_NpzH5File``, put in ``sys.modules`` for the
    loaders' ``import h5py`` (the caller takes it out again)."""
    import importlib.util
    import types

    if importlib.util.find_spec("h5py") is not None:
        import h5py

        return h5py, f"h5py {h5py.__version__}"
    mod = types.ModuleType("h5py")
    mod.File = _NpzH5File
    sys.modules["h5py"] = mod
    return mod, ("h5py is not installed on this machine: the h5 layouts are written and read "
                 "through chip_smoke's npz-backed stand-in for h5py.File")


def _counted(ops, fn):
    """``(fn(), the launch counts it made)``: the counts set to 0 just before
    and read just after."""
    ops.reset_launch_counts()
    out = fn()
    return out, {k: c for k, c in ops.launch_counts().items() if c}


def _jsonl_lines(log_dir) -> list[dict]:
    return [json.loads(x) for x in pathlib.Path(log_dir, "train.jsonl").read_text().splitlines()]


def _step_walls(lines: list[dict]) -> list[float]:
    """The wall seconds between consecutive metric lines (one a step)."""
    return [round(b["time"] - a["time"], 4) for a, b in zip(lines, lines[1:])]


def _check_trainer(what, state, log_dir, steps: int) -> list[dict]:
    lines = _jsonl_lines(log_dir)
    if state.step != steps or len(lines) != steps or not all(
            np.isfinite(v) for rec in lines for v in rec.values()):
        raise AssertionError(f"{what}: step {state.step}, metrics {lines}")
    if not pathlib.Path(log_dir, "ckpt", f"ckpt_{steps}.pt").exists():
        raise AssertionError(f"{what}: no checkpoint at step {steps}")
    return lines


def _add_counts(total: dict, counts: dict) -> None:
    for k, c in counts.items():
        total[k] = total.get(k, 0) + c


def run_data_slice(dev, ops, bench_slice, card, work) -> dict:
    """Slice (M): real-layout data. Writes ``M_SCANS`` ScanNet scans of
    ``M_VERTICES`` vertices, a ShapeNet-style and a PartNet-style h5 from a
    seed; preprocesses the scans with the port's CLI and reads the npz back;
    host ms a ``ScanNetCrops`` batch (B=4 x N=4096) on the native and the
    plain route, unsorted and ``morton``; the stage-1 training step on the
    first ``--scannet-dir --morton`` batch (RGB, feature_dim 3) through the
    kernel path and the plain path, bitwise; the trainers and the eval at
    the default presets on the files, each with the launch counts set to 0
    just before (stage 1 exactly (G)'s kernels a step; stage 2 (I)'s
    kernels; the eval (K)'s), the eval's ScanNet dumps named
    ``<scene>__crop<k>`` and read back, and its loop's kernel path against
    its plain path batch by batch; then the group kernels' device ms on
    the same crops unsorted and Morton-sorted. Returns the entry-point
    runs' launch counts summed."""
    _phase("slice (M)")
    root = pathlib.Path(work, "data")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(M_SCANS):
        _write_scan(root / "scans", f"scene{i:04d}_00", rng)
    h5, h5_note = _h5_module()
    try:
        return _data_slice(dev, ops, bench_slice, card, root, rng, h5, h5_note, t0)
    finally:
        if not hasattr(h5, "__version__"):
            sys.modules.pop("h5py", None)


def _data_slice(dev, ops, bench_slice, card, root, rng, h5, h5_note, t0) -> dict:
    """``run_data_slice`` once the scans are written and ``h5`` is chosen."""
    from gspn_tpu_torch.data import native, preprocess_scannet
    from gspn_tpu_torch.data.iterator import DeterministicBatches, to_device
    from gspn_tpu_torch.data.scannet import ScanNetCrops
    from gspn_tpu_torch.eval import run_eval
    from gspn_tpu_torch.models.gspn import GSPNConfig
    from gspn_tpu_torch.models.rpointnet import RPointNetConfig
    from gspn_tpu_torch.train import train_gspn, train_rpointnet

    b_obj, n_obj, n_cat = M_SHAPENET
    (root / "shapenet").mkdir()
    with h5.File(root / "shapenet" / "train0.h5", "w") as f:
        f.create_dataset("data", data=(rng.standard_normal((b_obj, n_obj, 3))
                                       * [0.5, 0.3, 0.4]).astype(np.float32))
        f.create_dataset("label", data=np.arange(b_obj) % n_cat)
    b_part, n_part = M_PARTNET
    (root / "partnet").mkdir()
    with h5.File(root / "partnet" / "train0.h5", "w") as f:
        f.create_dataset("pts", data=rng.uniform(-1, 1, (b_part, n_part, 3)).astype(np.float32))
        f.create_dataset("label", data=rng.integers(-1, 8, (b_part, n_part)))
        f.create_dataset("ins_label", data=rng.integers(-1, 12, (b_part, n_part)))
    print(f"slice (M) files: {M_SCANS} ScanNet scans x {M_VERTICES} vertices on "
          f"{M_FLOOR:g} x {M_FLOOR:g} m, ShapeNet h5 {b_obj} x {n_obj} ({n_cat} categories), "
          f"PartNet h5 {b_part} x {n_part}, written in {time.perf_counter() - t0:.1f} s; "
          f"{h5_note}")

    t0 = time.perf_counter()
    npz = root / "npz"
    written = preprocess_scannet.main(["--scans", str(root / "scans"), "--out", str(npz)])
    secs = time.perf_counter() - t0
    if len(written) != M_SCANS:
        raise AssertionError(f"preprocess_scannet wrote {written}")
    kept = []
    for p in written:
        with np.load(p) as z:
            a = {k: z[k] for k in z.files}
        if (a["xyz"].shape != (M_VERTICES, 3) or a["rgb"].shape != (M_VERTICES, 3)
                or not 0 <= a["rgb"].min() <= a["rgb"].max() <= 1
                or not 0 <= a["sem_label"].min() <= a["sem_label"].max() <= 18):
            raise AssertionError(f"{p.name}: {({k: (v.shape, v.min(), v.max()) for k, v in a.items()})}")
        kept.append(int(a["inst_label"].max()))
    if min(kept) < 1:
        raise AssertionError(f"a preprocessed scan kept no benchmark instance: {kept}")
    print(f"slice (M) preprocess_scannet: {M_SCANS} scans in {secs:.2f} s, read back: "
          f"{M_VERTICES} points each, benchmark instances {kept}")

    timing = {}
    for impl in ("native", "plain"):
        for morton in (False, True):
            ds = ScanNetCrops(str(npz), num_points=4096, morton=morton, impl=impl)
            ds.sample_batch(np.random.default_rng(0), 4)  # loads the scans
            ts = [_host_ms(lambda i=i: ds.sample_batch(np.random.default_rng(i + 1), 4))[0]
                  for i in range(M_BATCHES)]
            timing[impl, morton] = ts
            print(f"slice (M) host ms a ScanNetCrops batch (B=4 x N=4096), impl={impl}, "
                  f"morton={morton}: median {statistics.median(ts):.3f} (min {min(ts):.3f}, "
                  f"max {max(ts):.3f}; {M_BATCHES} batches) [{card}]")
    crop_ids = ScanNetCrops(str(npz), num_points=4096).sample_batch(
        np.random.default_rng(1), 1)["inst_label"][0]
    for impl in ("native", "plain"):
        ts = [_host_ms(lambda: native.compact_instance_ids(crop_ids, impl=impl))[0]
              for _ in range(M_BATCHES)]
        print(f"slice (M) host ms compact_instance_ids on one crop's 4096 ids, impl={impl}: "
              f"median {statistics.median(ts):.4f} (min {min(ts):.4f}, max {max(ts):.4f})")

    _phase("slice (M) kernel path vs plain path")
    scannet = ["--scannet-dir", str(npz)]
    args = train_gspn.parse_args(scannet + ["--morton"])
    first = DeterministicBatches(train_gspn.make_sample_fn(args), args.batch, args.seed
                                 ).batch_at(0)
    cfg = train_gspn.model_config(args, first)
    if cfg.feature_dim != 3 or first["xyz"].shape != (args.batch, args.num_points, 3):
        raise AssertionError(f"(M) the ScanNet batch's model: feature_dim {cfg.feature_dim}")
    batch = to_device(first, dev)
    model = bench_slice.seeded_gspn(cfg, dev)
    _, pmodel = bench_slice.plain_gspn(cfg, model)
    eps = torch.randn((args.batch, args.num_seeds, cfg.latent_dim),
                      generator=torch.Generator().manual_seed(1)).to(dev)
    (kfirst, kgrads, losses, times), counts = _counted(
        ops, lambda: _train_steps(bench_slice, model, batch, eps, M_STEPS))
    want = {k: c * (M_STEPS + 1) for k, c in G_PER_STEP.items()}
    if counts != want:
        raise AssertionError(f"(M) training steps launched {counts}, expected {want}")
    (pfirst, pgrads, plosses, ptimes), pcounts = _counted(
        ops, lambda: _train_steps(bench_slice, pmodel, batch, eps, M_STEPS))
    if pcounts:
        raise AssertionError(f"(M): the plain path launched {pcounts}")
    for k in kfirst:
        if not torch.equal(kfirst[k], pfirst[k]):
            raise AssertionError(f"(M) step 1 {k}: {kfirst[k].item()} vs {pfirst[k].item()}")
    differ = [k for k in kgrads if not torch.equal(kgrads[k], pgrads[k])]
    if differ or not torch.isfinite(losses).all():
        raise AssertionError(f"(M): step-1 gradients differ in {differ[:3]}, losses {losses}")
    _assert_same_training("(M) kernel path vs plain path", model, pmodel, losses, plosses)
    print(f"slice (M) stage 1 on the first --scannet-dir --morton batch (4 x 4096, RGB): kernel "
          f"path == plain path bitwise over 1 + {M_STEPS} steps (losses, step-1 gradients, "
          f"parameters, running statistics); losses {[round(x, 4) for x in losses.tolist()]}; "
          f"host ms a step kernel median {statistics.median(times):.3f}, plain "
          f"{statistics.median(ptimes):.3f} [{card}]")

    total = dict.fromkeys(ops.launch_counts(), 0)
    logs = root / "runs"
    steps = ["--steps", str(M_STEPS), "--log-every", "1", "--ckpt-every", str(M_STEPS)]
    gspn_log, rp_log = logs / "gspn", logs / "rpointnet"
    _phase("slice (M) train_gspn --scannet-dir --morton")
    state, counts = _counted(ops, lambda: train_gspn.main(
        scannet + ["--morton", "--log-dir", str(gspn_log)] + steps))
    lines = _check_trainer("(M) train_gspn --scannet-dir --morton", state, gspn_log, M_STEPS)
    want = {k: c * M_STEPS for k, c in G_PER_STEP.items()}
    if counts != want or state.model.config.feature_dim != 3:
        raise AssertionError(f"(M) train_gspn launched {counts}, expected {want}")
    _add_counts(total, counts)
    print(f"slice (M) train_gspn.main --scannet-dir --morton (default preset, feature_dim 3): "
          f"{M_STEPS} steps, launches {json.dumps(counts)}; losses "
          f"{[round(r['loss'], 4) for r in lines]}; wall s between logged steps "
          f"{_step_walls(lines)} [{card}]")

    _phase("slice (M) train_rpointnet --scannet-dir")
    state, counts = _counted(ops, lambda: train_rpointnet.main(
        scannet + ["--gspn-ckpt", str(gspn_log / "ckpt"), "--log-dir", str(rp_log)] + steps))
    lines = _check_trainer("(M) train_rpointnet --scannet-dir", state, rp_log, M_STEPS)
    if set(counts) != set(I_PER_STEP):
        raise AssertionError(f"(M) train_rpointnet launched {counts}, (I)'s kernels "
                             f"{sorted(I_PER_STEP)}")
    _add_counts(total, counts)
    print(f"slice (M) train_rpointnet.main --scannet-dir --gspn-ckpt: {M_STEPS} steps, "
          f"launches {json.dumps(counts)}; losses {[round(r['loss'], 4) for r in lines]}, "
          f"foreground RoIs {[r['num_fg'] for r in lines]}")

    _phase("slice (M) run_eval --scannet-dir")
    dumps = logs / "dumps"
    argv = scannet + ["--gspn-ckpt", str(gspn_log / "ckpt"), "--rpointnet-ckpt",
                      str(rp_log / "ckpt"), "--num-scenes", str(M_SCENES), "--score-thresh", "0"]
    summary, counts = _counted(ops, lambda: _eval_main(
        run_eval, argv + ["--dump-format", "scannet", "--dump-dir", str(dumps)]))
    if set(counts) != SLICE_KERNELS["K"] or summary["scenes"] != M_SCENES:
        raise AssertionError(f"(M) run_eval launched {counts}; summary {summary}")
    _add_counts(total, counts)
    eargs = run_eval.parse_args(argv)
    seen, names, valid_points = {}, [], []
    for b in run_eval.scene_batches(eargs)():
        for sid, v in zip(b["scene_ids"], b["valid"], strict=True):
            k = seen.get(sid, 0)
            seen[sid] = k + 1
            names.append(f"{sid}__crop{k}" if k else sid)
            valid_points.append(int(v.sum()))
    got = sorted(p.stem for p in dumps.glob("*.txt"))
    if got != sorted(names) or not any("__crop" in x for x in names):
        raise AssertionError(f"(M) run_eval dumps {got}, expected {sorted(names)}")
    n_masks = 0
    for name, nv in zip(names, valid_points, strict=True):
        for line in (dumps / f"{name}.txt").read_text().splitlines():
            mask = (dumps / line.split()[0]).read_text().split()
            n_masks += 1
            if len(mask) != nv or not set(mask) <= {"0", "1"}:
                raise AssertionError(f"(M) {name}: a mask of {len(mask)} lines, {nv} points")
    print(f"slice (M) run_eval.main --scannet-dir --dump-format scannet ({M_SCENES} crops of "
          f"{M_SCANS} scans): launches {json.dumps(counts)}; dumps {names} read back "
          f"({n_masks} masks); summary {json.dumps(summary)}")
    agree = _eval_paths_agree(run_eval, bench_slice, ops, argv, dev, "(M)")
    print(f"slice (M) the eval loop on the ScanNet crops: kernel path vs plain path batch by "
          f"batch, masks, valid and classes equal, scores and boxes within rtol 1e-4 / atol "
          f"1e-5: {json.dumps(agree)}")

    _phase("slice (M) ShapeNet and PartNet")
    sn_log, pn_log = logs / "shapenet", logs / "partnet"
    flags = ["--preset", "object", "--shapenet-dir", str(root / "shapenet"),
             "--shapenet-category", "1", "--num-points", "1024", "--log-dir", str(sn_log)]
    state, counts = _counted(ops, lambda: train_gspn.main(flags + steps))
    lines = _check_trainer("(M) train_gspn --shapenet-dir", state, sn_log, M_STEPS)
    if counts != {k: c * M_STEPS for k, c in OBJECT_PER_STEP.items()}:
        raise AssertionError(f"(M) train_gspn --shapenet-dir launched {counts}")
    _add_counts(total, counts)
    print(f"slice (M) train_gspn.main {' '.join(flags[:-2])}: {M_STEPS} steps, launches "
          f"{json.dumps(counts)}; losses {[round(r['loss'], 4) for r in lines]}")
    partnet = ["--partnet-dir", str(root / "partnet")]
    state, counts = _counted(ops, lambda: train_gspn.main(
        partnet + ["--log-dir", str(pn_log)] + steps))
    lines = _check_trainer("(M) train_gspn --partnet-dir", state, pn_log, M_STEPS)
    if counts != {k: c * M_STEPS for k, c in G_PER_STEP.items()}:
        raise AssertionError(f"(M) train_gspn --partnet-dir launched {counts}")
    _add_counts(total, counts)
    print(f"slice (M) train_gspn.main --partnet-dir (N=4096): {M_STEPS} steps, launches "
          f"{json.dumps(counts)}; losses {[round(r['loss'], 4) for r in lines]}")
    pargv = partnet + ["--gspn-ckpt", str(pn_log / "ckpt"), "--num-scenes", str(M_SCENES),
                       "--score-thresh", "0"]
    summary, counts = _counted(ops, lambda: _eval_main(run_eval, pargv))
    if set(counts) != SLICE_KERNELS["K"] or summary["scenes"] != M_SCENES:
        raise AssertionError(f"(M) run_eval --partnet-dir launched {counts}; {summary}")
    _add_counts(total, counts)
    print(f"slice (M) run_eval.main --partnet-dir (N=4096): launches {json.dumps(counts)}; "
          f"summary {json.dumps(summary)}")

    _phase("slice (M) Morton order and the group kernels")
    host = {morton: ScanNetCrops(str(npz), num_points=4096, morton=morton).sample_batch(
        np.random.default_rng(5), 4) for morton in (False, True)}
    for i in range(4):
        u, s = (host[m]["xyz"][i][host[m]["valid"][i]] for m in (False, True))
        if not np.array_equal(u[np.lexsort(u.T)], s[np.lexsort(s.T)]):
            raise AssertionError("(M) the sorted crop holds other points than the unsorted")
    crops = {m: tuple(torch.from_numpy(b[k]).to(dev) for k in ("xyz", "valid"))
             for m, b in host.items()}
    xu, vu = crops[False]
    centres = ops.gather_point(xu, ops.farthest_point_sample(1024, xu, vu))
    seeds = centres[:, :64]
    half = (torch.rand((4, 64, 3), generator=torch.Generator().manual_seed(2)) * 0.5
            + 0.1).to(dev)
    boxes = torch.cat([seeds - half, seeds + half], dim=-1)
    sa1, gcfg = RPointNetConfig().sa_layers[0], GSPNConfig()
    cases = {
        "ball_group SA1": ("ball_group", lambda x, v: ops.query_ball_group_multi(
            (sa1.radius,), (sa1.nsample,), x, centres, v, impl="cuda")),
        "ball_group crops": ("ball_group", lambda x, v: ops.query_ball_group_multi(
            gcfg.context_radii, gcfg.context_nsample, x, seeds, v, impl="cuda")),
        "box_group": ("box_group", lambda x, v: ops.query_box_group(
            boxes, RPointNetConfig().roi_samples, x, v, impl="cuda")),
    }
    morton_ms = {}
    for label, (kernel, fn) in cases.items():
        for order, (x, v) in (("unsorted", crops[False]), ("sorted", crops[True])):
            ms, events = tk.device_ms(lambda: fn(x, v), tk.ITERS, tk.SYMBOLS[kernel])
            morton_ms[f"{label} {order}"] = None if ms is None else round(ms, 5)
    print(f"slice (M) device ms on the same 4 x 4096 ScanNet crops unsorted and Morton-sorted "
          f"(torch.profiler, {tk.ITERS} launches; SA1 4 x 1024 centres r {sa1.radius} K "
          f"{sa1.nsample}, crops 4 x 64 seeds r {gcfg.context_radii} K "
          f"{gcfg.context_nsample}, boxes 4 x 64 S {RPointNetConfig().roi_samples}): "
          f"{json.dumps(morton_ms)} [{card}]")
    return total


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _state_close(what, model, ref, before: dict) -> dict:
    """Hold ``model``'s parameters and running statistics against ``ref``'s
    after one SGD step at lr 1 from ``before`` (a parameter's change is its
    gradient). At full width on the card the JAX package's DP bounds (rtol
    5e-5 / atol 2e-5) do not hold even between two single-process steps
    whose scenes are permuted in the batch (summation order alone moves the
    gradients of the layers before a BatchNorm, remainders of its
    cancellation, past them), so every tensor is held within the larger of
    those bounds taken of its largest magnitude and ``DP_GRAD_RTOL`` of its
    scale, element by element: a parameter's scale is its largest change, a
    Dense bias that feeds a BatchNorm (true gradient 0: rounding noise)
    takes its layer weight's, the running statistics their largest
    magnitude. A wrong global step (a per-rank normalizer or statistic, a
    gradient not averaged) moves a tensor by its own scale. Returns the
    largest gap over its bound and how many elements lie beyond the JAX
    bounds element by element, which are reported."""
    gap = _state_gap(model, ref, before)
    if gap["worst"] > 1.0:
        raise AssertionError(f"{what} {gap['worst_tensor']}: gap {gap['worst']:.3f} x its bound")
    return gap


def _state_gap(model, ref, before: dict) -> dict:
    """``_state_close``'s measure without its verdict: the largest gap over
    its bound, its tensor, and the elements beyond the JAX bounds."""
    from gspn_tpu_torch.utils.bench_slice import _BN_FED_BIAS

    got, want = model.state_dict(), ref.state_dict()
    params = {k for k, _ in ref.named_parameters()}
    worst, worst_k, beyond, total = 0.0, "", 0, 0
    for k, w in want.items():
        d = (got[k].float() - w.float()).abs()
        beyond += int((d > 2e-5 + 5e-5 * w.float().abs()).sum().item())
        total += w.numel()
        if k not in params:
            scale = w.abs().max().item()
        elif _BN_FED_BIAS.search(k):
            wk = k[: -len("bias")] + "weight"
            scale = (want[wk] - before[wk]).abs().max().item()
        else:
            scale = (w - before[k]).abs().max().item()
        bound = max(2e-5 + 5e-5 * w.abs().max().item(), DP_GRAD_RTOL * scale)
        ratio = d.max().item() / bound
        if ratio > worst:
            worst, worst_k = ratio, k
    return {"worst": worst, "worst_tensor": worst_k, "beyond_jax_bounds": beyond,
            "elements": total}


def _step_ms(step, model, batch, draws, n_steps: int) -> list[float]:
    """Host ms of ``n_steps`` steps (Adam at 1e-3) of ``step`` after a
    warm-up."""
    from gspn_tpu_torch.train.steps import TrainState, make_optimizer

    state = TrainState(model, make_optimizer(model, 1e-3))
    step(state, batch, **draws)
    return [_host_ms(lambda: step(state, batch, **draws))[0] for _ in range(n_steps)]


def _wait_ranks(what, procs, timeout: float) -> None:
    """Wait for the rank processes ``procs``; as soon as one exits non-zero
    (its peers would wait in a collective) or ``timeout`` seconds pass,
    kill the others and raise."""
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or \
                    time.perf_counter() - t0 > timeout:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if codes != [0] * len(procs):
        raise AssertionError(f"{what} ranks exited {codes} after "
                             f"{time.perf_counter() - t0:.1f} s")


def _dp_step_check(what, ops, mesh, model, ref, plain, loss_fn, dp_loss_fn, batch,
                   draws) -> dict:
    """One SGD (lr 1) step of ``model`` on this rank's rows of ``batch``
    through ``make_dp_train_step``, and of ``ref`` (the same weights) on the
    whole batch through the single-process step: the loss within rtol 1e-6,
    the parameters and running statistics as ``_state_close`` holds them;
    and the same DP step of ``plain`` (the same weights on the plain ops)
    bitwise ``model``'s. Returns the losses, the gaps and the kernel path's
    launch counts."""
    from gspn_tpu_torch.parallel import make_dp_train_step, shard_batch
    from gspn_tpu_torch.train.steps import TrainState, make_train_step

    def sgd(m):
        return TrainState(m, torch.optim.SGD(m.parameters(), lr=1.0))


    before = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    got, counts = _counted(ops, lambda: make_dp_train_step(dp_loss_fn, mesh)(
        sgd(model), shard_batch(mesh, batch), **draws))
    want = make_train_step(loss_fn)(sgd(ref), batch, **draws)
    make_dp_train_step(dp_loss_fn, mesh)(sgd(plain), shard_batch(mesh, batch), **draws)
    ps = plain.state_dict()
    differ = [k for k, v in model.state_dict().items() if not torch.equal(v, ps[k])]
    if differ:
        raise AssertionError(f"(N) {what}: the DP step's kernel path and plain path differ in "
                             f"{differ[:3]}")
    if abs(got["loss"].item() - want["loss"].item()) > 1e-6 * abs(want["loss"].item()):
        raise AssertionError(f"(N) {what}: DP loss {got['loss'].item()} vs "
                             f"{want['loss'].item()}")
    close = _state_close(f"(N) {what}", model, ref, before)
    return {"loss": got["loss"].item(), "single_loss": want["loss"].item(), **close,
            "launches": counts}


def _dp_step_ms(mesh, model, dp_loss_fn, batch, draws) -> list[float]:
    """Host ms of ``N_STEPS`` DP steps (Adam at 1e-3) after a warm-up."""
    from gspn_tpu_torch.parallel import make_dp_train_step, shard_batch

    return _step_ms(make_dp_train_step(dp_loss_fn, mesh), model, shard_batch(mesh, batch), draws,
                    N_STEPS)


def _dp_work(mesh, ops, bench_slice) -> dict:
    """(N) on this rank: stage 1 (``train_config()``, (G)'s batch and
    noise) and stage 2 (``stage2_configs()`` without head dropout or
    randomized RoIs, which the DP loss refuses; (I)'s draws): one DP step
    against the single-process step on the whole batch, each, then host ms
    a DP step of each. Returns what it measured and the launch counts of
    the DP steps."""
    import dataclasses
    import hashlib

    from gspn_tpu_torch.train.steps import make_gspn_loss_fn, make_rpointnet_loss_fn

    dev = mesh.device
    dp = {"dp_group": mesh.group, "dp_size": mesh.size}
    batch = bench_slice.train_batch(dev)
    cfg = bench_slice.train_config()
    eps = torch.randn((bench_slice.TRAIN_BATCH, bench_slice.TRAIN_SEEDS, cfg.latent_dim),
                      generator=torch.Generator().manual_seed(1)).to(dev)
    s1 = (bench_slice.TRAIN_SEEDS, bench_slice.TRAIN_GT)
    gcfg, rcfg = bench_slice.stage2_configs()
    rcfg = dataclasses.replace(rcfg, head_dropout=0.0, roi_randomize=False)
    gmodel = bench_slice.seeded_frozen_gspn(gcfg, dev)
    frozen = (gmodel, bench_slice.TRAIN_SEEDS)
    draws2 = _stage2_draws(gcfg, bench_slice.TRAIN_BATCH, 1, dev)
    out = {}
    model = bench_slice.seeded_gspn(cfg, dev)
    out["stage1"] = _dp_step_check(
        "stage 1", ops, mesh, model, bench_slice.seeded_gspn(cfg, dev),
        bench_slice.plain_gspn(cfg, bench_slice.seeded_gspn(cfg, dev))[1], make_gspn_loss_fn(*s1),
        make_gspn_loss_fn(*s1, **dp), batch, {"z_eps": eps})
    digest = hashlib.sha256()
    for v in model.state_dict().values():
        digest.update(v.detach().cpu().numpy().tobytes())
    model = bench_slice.seeded_rpointnet(rcfg, dev)
    out["stage2"] = _dp_step_check(
        "stage 2", ops, mesh, model, bench_slice.seeded_rpointnet(rcfg, dev),
        bench_slice.plain_rpointnet(rcfg, bench_slice.seeded_rpointnet(rcfg, dev))[1],
        make_rpointnet_loss_fn(bench_slice.STAGE2_INSTANCES, frozen),
        make_rpointnet_loss_fn(bench_slice.STAGE2_INSTANCES, frozen, **dp), batch, draws2)
    for v in model.state_dict().values():
        digest.update(v.detach().cpu().numpy().tobytes())
    out["state_sha256"] = digest.hexdigest()
    out["ms_stage1"] = _dp_step_ms(mesh, bench_slice.seeded_gspn(cfg, dev),
                                   make_gspn_loss_fn(*s1, **dp), batch, {"z_eps": eps})
    out["ms_stage2"] = _dp_step_ms(mesh, bench_slice.seeded_rpointnet(rcfg, dev),
                                   make_rpointnet_loss_fn(bench_slice.STAGE2_INSTANCES, frozen,
                                                          **dp), batch, draws2)
    return out


def _dp_rank_main(work, device: str = "cuda") -> None:
    """The ``--dp-rank WORK`` process: one rank of (N)'s group (the
    ``torch.distributed`` environment from ``run_dp_slice``): ``_dp_work``,
    then ``train_gspn --dp`` for 3 steps and ``train_rpointnet --dp`` for 2
    on that checkpoint, every rank on the same log directories (rank 0
    writes); its results in ``WORK/dp_rank<r>.json``."""
    from gspn_tpu_torch import ops
    from gspn_tpu_torch.ops import _cuda
    from gspn_tpu_torch.parallel import make_mesh
    from gspn_tpu_torch.train import train_gspn, train_rpointnet
    from gspn_tpu_torch.utils import bench_slice

    bench_slice.pin_float32_matmuls()
    _cuda.library()
    mesh = make_mesh(device, n_ranks=N_RANKS)
    try:
        out = _dp_work(mesh, ops, bench_slice)
        log = pathlib.Path(work, "dp")
        out["train_gspn_ms"] = _host_ms(lambda: train_gspn.main(
            ["--dp", "--steps", "3", "--log-every", "1", "--ckpt-every", "3",
             "--log-dir", str(log / "gspn")]))[0]
        out["train_rpointnet_ms"] = _host_ms(lambda: train_rpointnet.main(
            ["--dp", "--steps", "2", "--log-every", "1", "--ckpt-every", "2",
             "--gspn-ckpt", str(log / "gspn" / "ckpt"), "--log-dir", str(log / "rpointnet")]))[0]
        out["backend"] = torch.distributed.get_backend()
        pathlib.Path(work, f"dp_rank{mesh.rank}.json").write_text(json.dumps(out))
    finally:
        mesh.close()


def run_dp_slice(dev, ops, bench_slice, card, work) -> dict:
    """Slice (N): data-parallel training. ``N_RANKS`` processes of this
    script (``--dp-rank WORK``) on this one card form a ``torch.distributed``
    group (gloo, since the card is shared; NCCL where each rank has a card),
    waited for with a time limit and killed past it; each runs
    ``_dp_work`` (each stage's DP step against the single-process step on
    the whole batch) and the trainers' ``--dp``. Here, a one-rank group
    times the same DP steps. Raises unless every rank exited 0, the ranks
    hold the same state, rank 0 alone wrote the trainers' files. Returns
    the ranks' launch counts summed (their checked DP steps), each rank's
    exactly (G)'s and (I)'s point kernels a step."""
    from gspn_tpu_torch.parallel import make_mesh

    _phase("slice (N)")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(N_RANKS), LOCAL_WORLD_SIZE=str(N_RANKS))
    procs = [subprocess.Popen([sys.executable, __file__, "--dp-rank", str(work)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(N_RANKS)]
    _wait_ranks("(N)", procs, 600)
    res = [json.loads(pathlib.Path(work, f"dp_rank{r}.json").read_text())
           for r in range(N_RANKS)]
    if len({r["state_sha256"] for r in res}) != 1:
        raise AssertionError("(N) the ranks' parameters differ after their DP steps")
    log = pathlib.Path(work, "dp")
    for name, steps in (("gspn", 3), ("rpointnet", 2)):
        lines = _jsonl_lines(log / name)
        if len(lines) != steps or not (log / name / "ckpt" / f"ckpt_{steps}.pt").exists() or \
                not all(np.isfinite(v) for rec in lines for v in rec.values()):
            raise AssertionError(f"(N) train_{name} --dp: {lines}")
    r0 = res[0]
    for stage in ("stage1", "stage2"):
        print(f"slice (N) {stage}: the {N_RANKS}-rank DP step ({r0['backend']}, one card) "
              f"== the single-process step on the whole batch (B=4 x N=4096): loss "
              f"{r0[stage]['loss']:.6f} vs {r0[stage]['single_loss']:.6f} (rtol 1e-6); every "
              f"tensor within max(rtol 5e-5 / atol 2e-5 of its largest magnitude, "
              f"{DP_GRAD_RTOL} of its scale) (largest gap over its bound "
              f"{r0[stage]['worst']:.3f}, {r0[stage]['worst_tensor']}); elements beyond the "
              f"JAX package's rtol 5e-5 / atol 2e-5: {r0[stage]['beyond_jax_bounds']} of "
              f"{r0[stage]['elements']}; the DP step's kernel path == its plain path bitwise; "
              f"every rank the same state")
    print(f"slice (N) train_gspn --dp 3 steps and train_rpointnet --dp 2 steps on "
          f"{N_RANKS} ranks: rank 0 wrote each checkpoint and {3}, {2} finite metric lines; "
          f"host ms {r0['train_gspn_ms']:.1f}, {r0['train_rpointnet_ms']:.1f} (whole runs)")

    mesh = make_mesh(dev, n_ranks=1)
    try:
        one = _dp_work(mesh, ops, bench_slice)
    finally:
        mesh.close()
    for stage in ("stage1", "stage2"):
        ts1, ts2 = one[f"ms_{stage}"], r0[f"ms_{stage}"]
        print(f"slice (N) {stage} host ms a DP step (Adam, B=4 x N=4096 in all): 1 rank median "
              f"{statistics.median(ts1):.3f} (min {min(ts1):.3f}, max {max(ts1):.3f}); "
              f"{N_RANKS} ranks on one card median {statistics.median(ts2):.3f} (min "
              f"{min(ts2):.3f}, max {max(ts2):.3f}); {N_STEPS} steps after a warm-up [{card}]")
    total = dict.fromkeys(ops.launch_counts(), 0)
    for r in res:  # the DP steps' BatchNorms take cross-rank statistics: the module's code
        for stage, per_step in (("stage1", G_POINTS), ("stage2", I_POINTS)):
            if r[stage]["launches"] != per_step:
                raise AssertionError(f"(N) a rank's {stage} DP step launched "
                                     f"{r[stage]['launches']}, expected {per_step}")
            _add_counts(total, r[stage]["launches"])
    return total


def _ps_inference(meshes, ops, bench_slice) -> dict:
    """(O)'s requests on this rank: (A)'s config, weights and noise, the
    flagship on the 1-D mesh and on the 2 x 2 one, the whole scene on the
    1-D mesh, each through ``make_point_sharded_inference``: its kernel
    path (launch counts set to 0 just before) against its plain path (the
    parity rule) and against the single-process ``make_inference_fn`` on
    the same weights and noise (classes and validity equal, at most
    ``O_MASK_SHARE`` of the mask cells differing); then ``O_REQUESTS``
    timed requests. Raises unless a sharded request launches exactly the
    single-process request's kernels (those of (A)) and its plain path
    none."""
    from gspn_tpu_torch.models.pipeline import make_inference_fn
    from gspn_tpu_torch.parallel import make_point_sharded_inference

    dev = meshes["1-D"].device
    cfg = bench_slice.slice_config()
    model = bench_slice.seeded_model(cfg, dev)
    pcfg, pmodel = bench_slice.plain_model(cfg, model)
    single = make_inference_fn(cfg)
    out = {}
    for label, shape, seed in (("1-D", FLAGSHIP, 1), ("2x2", FLAGSHIP, 1), ("1-D", WHOLE_SCENE, 2)):
        what = f"(O) {label} {shape}"
        xyz, valid, eps = bench_slice.request(cfg, shape, dev, seed)
        infer = make_point_sharded_inference(cfg, meshes[label])
        pinfer = make_point_sharded_inference(pcfg, meshes[label])
        with torch.inference_mode():
            got, counts = _counted(ops, lambda: infer(model, xyz, valid, eps))
            want, single_counts = _counted(ops, lambda: single(model, xyz, valid, z_eps=eps))
            plain, plain_counts = _counted(ops, lambda: pinfer(pmodel, xyz, valid, eps))
            times = [_host_ms(lambda: infer(model, xyz, valid, eps))[0]
                     for _ in range(O_REQUESTS)]
        if counts != single_counts or set(counts) != SLICE_KERNELS["A"] or plain_counts:
            raise AssertionError(f"{what}: launches {counts}, single-process {single_counts}, "
                                 f"plain path {plain_counts}")
        for f in ("masks", "valid", "classes"):
            if not torch.equal(getattr(got, f), getattr(plain, f)):
                raise AssertionError(f"{what}: kernel and plain paths differ in {f}")
        for f in ("scores", "boxes"):
            torch.testing.assert_close(getattr(got, f), getattr(plain, f), rtol=1e-4, atol=1e-5)
        share = got.masks[got.valid].float().mean().item()
        flipped = (got.masks != want.masks).float().mean().item()
        same = {f: torch.equal(getattr(got, f), getattr(want, f)) for f in FIELDS}
        if not (same["classes"] and same["valid"]) or flipped > O_MASK_SHARE \
                or not 0.0 < share < 1.0:
            raise AssertionError(f"{what} against the single-process request: {same}, mask "
                                 f"cells that differ {flipped}, mask share {share}")
        out[f"{label} {shape}"] = {
            "times": times, "launches": counts, "mask_share": share, "mask_flipped": flipped,
            "same": same, "score_gap": (got.scores - want.scores).abs().max().item(),
            "box_gap": (got.boxes - want.boxes).abs().max().item()}
    return out


def _ps_step_check(what, ops, mesh, models, step, plain_step, single_step, batch, draws,
                   follow: bool = False) -> dict:
    """One SGD (lr 1) sharded step of a model from ``models()`` (a fresh
    seeded model a call) on the whole ``batch`` (launch counts set to 0
    just before), the same step of the model on the plain ops
    (``models(plain=True)``), which must launch nothing and give the same
    state bit for bit, and the single-process step on the whole batch: the
    loss within rtol 1e-5, every tensor as ``_state_close`` holds it.
    ``follow`` (stage 2): the heads' max pool of the sharded step held to
    the bound follows the single-process step's picks on this rank's RoIs
    (``bench_slice.follow_max_ties``, each forced cell asserted a
    near-tie); the gap without it is reported."""
    import hashlib

    from gspn_tpu_torch.train.steps import TrainState
    from gspn_tpu_torch.utils.bench_slice import follow_max_ties

    def sgd(m):
        return TrainState(m, torch.optim.SGD(m.parameters(), lr=1.0))

    ref, model, plain = models(), models(), models(plain=True)
    before = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    picks = []
    hook = ref.heads.roi_mlp.register_forward_hook(
        lambda m, i, o: picks.append(o.detach())) if follow else None
    want = single_step(sgd(ref), batch, **draws)
    if hook is not None:
        hook.remove()
    got, counts = _counted(ops, lambda: step(sgd(model), batch, **draws))
    _, plain_counts = _counted(ops, lambda: plain_step(sgd(plain), batch, **draws))
    ps = plain.state_dict()
    differ = [k for k, v in model.state_dict().items() if not torch.equal(v, ps[k])]
    if differ or plain_counts:
        raise AssertionError(f"(O) {what}: the sharded step's plain path launched "
                             f"{plain_counts} and differs from its kernel path in {differ[:3]}")
    if abs(got["loss"].item() - want["loss"].item()) > 1e-5 * abs(want["loss"].item()):
        raise AssertionError(f"(O) {what}: sharded loss {got['loss'].item()} vs "
                             f"{want['loss'].item()}")
    digest = hashlib.sha256()
    for v in model.state_dict().values():
        digest.update(v.detach().cpu().numpy().tobytes())
    out = {"loss": got["loss"].item(), "single_loss": want["loss"].item(), "launches": counts,
           "sha256": digest.hexdigest()}
    if follow:
        out["unfollowed"] = _state_gap(model, ref, before)
        per = picks[0].shape[1] // mesh.n_space
        model = models()
        forced, _ = follow_max_ties(model, picks[0][:, mesh.space_index * per:][:, :per])
        step(sgd(model), batch, **draws)
        out["forced_cells"] = forced
    return {**out, **_state_close(f"(O) {what}", model, ref, before)}


def _ps_training(mesh, ops, bench_slice) -> dict:
    """(O)'s training on this rank, on the 1-D mesh: stage 1 at (G)'s config,
    batch and noise and stage 2 at (I)'s (``stage2_configs()`` without head
    dropout or randomized RoIs, which the sharded step refuses; 64 seeds +
    16 GT boxes = 80 RoIs a scene), one checked step each
    (``_ps_step_check``), then ``O_STEPS`` timed sharded steps of each.
    Returns what it measured and the launch counts of the checked steps."""
    import dataclasses

    from gspn_tpu_torch.parallel import (
        make_point_sharded_gspn_train_step,
        make_point_sharded_rpointnet_train_step,
    )
    from gspn_tpu_torch.train.steps import (
        make_gspn_loss_fn, make_rpointnet_loss_fn, make_train_step,
    )

    dev = mesh.device
    batch = bench_slice.train_batch(dev)
    cfg = bench_slice.train_config()
    eps = torch.randn((bench_slice.TRAIN_BATCH, bench_slice.TRAIN_SEEDS, cfg.latent_dim),
                      generator=torch.Generator().manual_seed(1)).to(dev)
    s1 = (bench_slice.TRAIN_SEEDS, bench_slice.TRAIN_GT)
    gcfg, rcfg = bench_slice.stage2_configs()
    rcfg = dataclasses.replace(rcfg, head_dropout=0.0, roi_randomize=False)
    gmodel = bench_slice.seeded_frozen_gspn(gcfg, dev)
    frozen = (gmodel, bench_slice.TRAIN_SEEDS)
    pfrozen = (bench_slice.plain_gspn(gcfg, gmodel)[1], bench_slice.TRAIN_SEEDS)
    draws2 = _stage2_draws(gcfg, bench_slice.TRAIN_BATCH, 1, dev)
    inst = bench_slice.STAGE2_INSTANCES
    def gspns(plain=False):
        model = bench_slice.seeded_gspn(cfg, dev)
        return bench_slice.plain_gspn(cfg, model)[1] if plain else model

    def rpointnets(plain=False):
        model = bench_slice.seeded_rpointnet(rcfg, dev)
        return bench_slice.plain_rpointnet(rcfg, model)[1] if plain else model

    pcfg, prcfg = (dataclasses.replace(c, ops_impl="plain") for c in (cfg, rcfg))
    out = {"stage1": _ps_step_check(
        "stage 1", ops, mesh, gspns, make_point_sharded_gspn_train_step(cfg, mesh, *s1),
        make_point_sharded_gspn_train_step(pcfg, mesh, *s1),
        make_train_step(make_gspn_loss_fn(*s1)), batch, {"z_eps": eps})}
    out["stage2"] = _ps_step_check(
        "stage 2", ops, mesh, rpointnets,
        make_point_sharded_rpointnet_train_step(rcfg, mesh, inst, frozen),
        make_point_sharded_rpointnet_train_step(prcfg, mesh, inst, pfrozen),
        make_train_step(make_rpointnet_loss_fn(inst, frozen)), batch, draws2, follow=True)
    out["ms_stage1"] = _step_ms(make_point_sharded_gspn_train_step(cfg, mesh, *s1),
                                bench_slice.seeded_gspn(cfg, dev), batch, {"z_eps": eps},
                                O_STEPS)
    out["ms_stage2"] = _step_ms(make_point_sharded_rpointnet_train_step(rcfg, mesh, inst, frozen),
                                bench_slice.seeded_rpointnet(rcfg, dev), batch, draws2, O_STEPS)
    return out


def _ps_eval(run_eval, mesh, ops, log) -> dict:
    """``run_eval --point-sharded`` on (O)'s trainer checkpoints, 8 scenes
    at ``--score-thresh 0`` (launch counts set to 0 just before; the
    summary line rank 0 prints), then the eval loop on the same scenes,
    weights and noise with the sharded ``infer`` and the single-process one
    as its paired arm, batch by batch: classes and validity equal, at most
    ``O_MASK_SHARE`` of the mask cells differing."""
    import contextlib
    import io

    argv = ["--point-sharded", "--num-scenes", "8", "--score-thresh", "0",
            "--gspn-ckpt", str(log / "gspn" / "ckpt"),
            "--rpointnet-ckpt", str(log / "rpointnet" / "ckpt"), "--dump-dir", str(log / "dumps")]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, counts = _counted(ops, lambda: run_eval.main(argv))
    lines = buf.getvalue().strip().splitlines()
    args = run_eval.parse_args(argv)
    cfg, state, z_eps = _eval_weights(run_eval, args, mesh.device)
    outs = {"sharded": [], "single": []}

    def recording(key, infer):
        def call(*a, **kw):
            outs[key].append(infer(*a, **kw))
            return outs[key][-1]
        return call

    run_eval.evaluate(recording("sharded", run_eval.live_infer(cfg, state, mesh.device, mesh)),
                      run_eval.scene_batches(args)(), z_eps,
                      recording("single", run_eval.live_infer(cfg, state, mesh.device)))
    flipped, valid = [], 0
    for i, (got, want) in enumerate(zip(outs["sharded"], outs["single"], strict=True)):
        if not (torch.equal(got.classes, want.classes) and torch.equal(got.valid, want.valid)):
            raise AssertionError(f"(O) run_eval batch {i}: the sharded and single-process "
                                 "predictions differ in classes or validity")
        flipped.append((got.masks != want.masks).float().mean().item())
        valid += int(got.valid.sum())
    if max(flipped) > O_MASK_SHARE:
        raise AssertionError(f"(O) run_eval: mask cells that differ a batch {flipped}")
    return {"launches": counts, "summary": lines[-1] if lines else None, "flipped": flipped,
            "valid": valid}


def _ps_rank_main(work, device: str = "cuda") -> None:
    """The ``--ps-rank WORK`` process: one rank of (O)'s group (the
    ``torch.distributed`` environment from ``run_point_sharded_slice``): a
    1-D mesh of every rank and a 2 x 2 one, ``_ps_inference`` and
    ``_ps_training``, then ``train_gspn --point-sharded`` for 3 steps,
    ``train_rpointnet --point-sharded --data-rows 2`` for 2 on that
    checkpoint and ``_ps_eval``, every rank on the same log directories
    (rank 0 writes), each entry point's launch counts read; its results in
    ``WORK/ps_rank<r>.json``."""
    from gspn_tpu_torch import ops
    from gspn_tpu_torch.eval import run_eval
    from gspn_tpu_torch.ops import _cuda
    from gspn_tpu_torch.parallel import make_mesh_2d
    from gspn_tpu_torch.train import train_gspn, train_rpointnet
    from gspn_tpu_torch.utils import bench_slice

    bench_slice.pin_float32_matmuls()
    _cuda.library()
    mesh = make_mesh_2d(1, O_RANKS, device=device)
    try:
        meshes = {"1-D": mesh, "2x2": make_mesh_2d(2, O_RANKS // 2, device=device)}
        out = {"inference": _ps_inference(meshes, ops, bench_slice),
               "training": _ps_training(mesh, ops, bench_slice)}
        log = pathlib.Path(work, "ps")
        entry = {}
        entry["train_gspn"] = _counted(ops, lambda: _host_ms(lambda: train_gspn.main(
            ["--point-sharded", "--steps", "3", "--log-every", "1", "--ckpt-every", "3",
             "--log-dir", str(log / "gspn")]))[0])
        entry["train_rpointnet"] = _counted(ops, lambda: _host_ms(lambda: train_rpointnet.main(
            ["--point-sharded", "--data-rows", "2", "--steps", "2", "--log-every", "1",
             "--ckpt-every", "2", "--gspn-ckpt", str(log / "gspn" / "ckpt"),
             "--log-dir", str(log / "rpointnet")]))[0])
        out["entry"] = entry
        out["eval"] = _ps_eval(run_eval, mesh, ops, log)
        out["backend"] = torch.distributed.get_backend()
        pathlib.Path(work, f"ps_rank{mesh.rank}.json").write_text(json.dumps(out))
    finally:
        mesh.close()


def run_point_sharded_slice(dev, ops, bench_slice, card, work) -> dict:
    """Slice (O): point-sharded inference and training. ``O_RANKS``
    processes of this script (``--ps-rank WORK``) on this one card form a
    ``torch.distributed`` group (gloo, since the card is shared: (O) shows
    correctness and plumbing, not scaling), waited for with a time limit
    and killed past it; each runs ``_ps_rank_main``. Here, the
    single-process eager request at both shapes and the single-process
    step of each stage are timed beside the ranks' sharded ones. Raises
    unless every rank exited 0, the ranks hold the same state after their
    checked steps, each rank's checked steps and entry points launched
    their slices' kernels ((G)'s and (I)'s a step, (K)'s in the eval), and
    rank 0 alone wrote the trainers' files and the dumps. Returns the
    ranks' launch counts summed (their checked requests and steps)."""
    import dataclasses

    from gspn_tpu_torch.models.pipeline import make_inference_fn
    from gspn_tpu_torch.train.steps import (
        make_gspn_loss_fn, make_rpointnet_loss_fn, make_train_step,
    )

    _phase("slice (O)")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(O_RANKS), LOCAL_WORLD_SIZE=str(O_RANKS),
               OMP_NUM_THREADS="1")  # as torchrun sets it for several ranks a host
    procs = [subprocess.Popen([sys.executable, __file__, "--ps-rank", str(work)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(O_RANKS)]
    _wait_ranks("(O)", procs, 600)
    res = [json.loads(pathlib.Path(work, f"ps_rank{r}.json").read_text())
           for r in range(O_RANKS)]
    if len({(r["training"]["stage1"]["sha256"], r["training"]["stage2"]["sha256"])
            for r in res}) != 1:
        raise AssertionError("(O) the ranks' parameters differ after their sharded steps")
    log = pathlib.Path(work, "ps")
    for name, steps in (("gspn", 3), ("rpointnet", 2)):
        lines = _jsonl_lines(log / name)
        if len(lines) != steps or not (log / name / "ckpt" / f"ckpt_{steps}.pt").exists() or \
                not all(np.isfinite(v) for rec in lines for v in rec.values()):
            raise AssertionError(f"(O) train_{name} --point-sharded: {lines}")
    dumps = sorted(p.name for p in (log / "dumps").iterdir())
    if len(dumps) != 8:
        raise AssertionError(f"(O) run_eval --point-sharded dumped {dumps}")
    total = dict.fromkeys(ops.launch_counts(), 0)
    for r in res:  # the sharded steps' BatchNorms take cross-rank statistics: the module's code
        for stage, per_step in (("stage1", G_POINTS), ("stage2", I_POINTS)):
            if r["training"][stage]["launches"] != per_step:
                raise AssertionError(f"(O) a rank's {stage} sharded step launched "
                                     f"{r['training'][stage]['launches']}, expected {per_step}")
            _add_counts(total, r["training"][stage]["launches"])
        for case in r["inference"].values():
            _add_counts(total, case["launches"])
        for name, steps, per_step in (("train_gspn", 3, G_POINTS),
                                      ("train_rpointnet", 2, I_POINTS)):
            got = r["entry"][name][1]
            if got != {k: steps * c for k, c in per_step.items()}:
                raise AssertionError(f"(O) {name} --point-sharded launched {got} on a rank")
        if set(r["eval"]["launches"]) != SLICE_KERNELS["K"]:
            raise AssertionError(f"(O) run_eval --point-sharded launched {r['eval']['launches']}")
    r0 = res[0]
    for key, case in r0["inference"].items():
        print(f"slice (O) {key}: {O_RANKS} ranks ({r0['backend']}, one card); kernel path == "
              f"plain path (parity rule); against the single-process request: classes and "
              f"valid equal, mask cells that differ {case['mask_flipped']:.6f} (bound "
              f"{O_MASK_SHARE}), scores' largest gap {case['score_gap']:.3e}, boxes' "
              f"{case['box_gap']:.3e}, bitwise {json.dumps(case['same'])}; mask share "
              f"{case['mask_share']:.4f}; each rank launched the single-process request's "
              f"kernels {json.dumps(case['launches'])}")
    for stage in ("stage1", "stage2"):
        t = r0["training"][stage]
        followed = ""
        if "forced_cells" in t:
            u = t["unfollowed"]
            followed = (f" with the heads' max pool following the single-process step's picks "
                        f"(forced near-tie cells on the ranks: "
                        f"{[r['training'][stage]['forced_cells'] for r in res]}; without it "
                        f"the largest gap is {u['worst']:.3f} of the bound, {u['worst_tensor']})")
        print(f"slice (O) {stage}: the {O_RANKS}-rank point-sharded step == the single-process "
              f"step on the whole batch (B=4 x N=4096): loss {t['loss']:.6f} vs "
              f"{t['single_loss']:.6f} (rtol 1e-5); every tensor within _state_close's bound"
              f"{followed} (largest gap over it {t['worst']:.3f}, {t['worst_tensor']}); "
              f"elements beyond the JAX package's rtol 5e-5 / atol 2e-5: "
              f"{t['beyond_jax_bounds']} of {t['elements']}; its kernel path == its plain path "
              f"bitwise; every rank the same state; launches a step {json.dumps(t['launches'])}")
    ev = r0["eval"]
    print(f"slice (O) train_gspn --point-sharded 3 steps (1 x {O_RANKS}), train_rpointnet "
          f"--point-sharded --data-rows 2 2 steps (2 x {O_RANKS // 2}), run_eval "
          f"--point-sharded 8 scenes: rank 0 wrote each checkpoint, 3 and 2 metric lines and "
          f"8 dumps; host ms {r0['entry']['train_gspn'][0]:.1f}, "
          f"{r0['entry']['train_rpointnet'][0]:.1f} (whole runs); the eval's sharded "
          f"predictions against the single-process ones batch by batch: classes and valid "
          f"equal over {ev['valid']} valid instances, mask cells that differ "
          f"{json.dumps([round(x, 6) for x in ev['flipped']])}; summary {ev['summary']}")

    cfg = bench_slice.slice_config()
    model = bench_slice.seeded_model(cfg, dev)
    single = make_inference_fn(cfg)
    for seed, shape in ((1, FLAGSHIP), (2, WHOLE_SCENE)):
        xyz, valid, eps = bench_slice.request(cfg, shape, dev, seed)
        with torch.inference_mode():
            single(model, xyz, valid, z_eps=eps)
            ts = [_host_ms(lambda: single(model, xyz, valid, z_eps=eps))[0]
                  for _ in range(O_REQUESTS)]
        sharded = "; ".join(f"{k.split()[0]} {_span(c['times'])}"
                            for k, c in r0["inference"].items() if k.endswith(shape))
        print(f"slice (O) host ms a {shape} request, median (min-max): single-process eager "
              f"{_span(ts)}; {O_RANKS} ranks sharded {sharded}; {O_REQUESTS} after "
              f"a warm-up, the ranks sharing one card [{card}]")
    batch = bench_slice.train_batch(dev)
    gcfg, rcfg = bench_slice.stage2_configs()
    rcfg = dataclasses.replace(rcfg, head_dropout=0.0, roi_randomize=False)
    eps = torch.randn((bench_slice.TRAIN_BATCH, bench_slice.TRAIN_SEEDS,
                       bench_slice.train_config().latent_dim),
                      generator=torch.Generator().manual_seed(1)).to(dev)
    frozen = (bench_slice.seeded_frozen_gspn(gcfg, dev), bench_slice.TRAIN_SEEDS)
    for stage, step, model, draws in (
            ("stage1", make_train_step(make_gspn_loss_fn(bench_slice.TRAIN_SEEDS,
                                                         bench_slice.TRAIN_GT)),
             bench_slice.seeded_gspn(bench_slice.train_config(), dev), {"z_eps": eps}),
            ("stage2", make_train_step(make_rpointnet_loss_fn(bench_slice.STAGE2_INSTANCES,
                                                              frozen)),
             bench_slice.seeded_rpointnet(rcfg, dev), _stage2_draws(gcfg, 4, 1, dev))):
        ts = _step_ms(step, model, batch, draws, O_STEPS)
        print(f"slice (O) {stage} host ms a step (Adam, B=4 x N=4096), median (min-max): "
              f"single-process {_span(ts)}; {O_RANKS} ranks point-sharded on one card "
              f"{_span(r0['training'][f'ms_{stage}'])}; {O_STEPS} after a warm-up [{card}]")
    return total


# slice (P): the export CLI's flags for (A)'s flagship (the CLI's default
# preset, scannet_pipeline() but for the crops' K of 64/128/256, with (A)'s
# spatial segmented FPS, every proposal kept as in (A)) and for the small
# scene the dual artifact's CPU program runs; the library modules at
# PointNet++'s published MSG widths (charlesq34/pointnet2
# models/pointnet2_cls_msg.py) and B x N of its training
P_FLAGSHIP = ["--batch", str(B), "--num-points", str(N), "--fps-segments", "8",
              "--fps-segment-mode", "spatial", "--score-thresh", "0"]
P_SMALL = ["--batch", "2", "--num-points", "2048", "--fps-segments", "8",
           "--fps-segment-mode", "spatial", "--score-thresh", "0"]
P_B, P_N = 16, 1024
P_MSG = (  # npoint, radii, K, MLPs
    (512, (0.1, 0.2, 0.4), (16, 32, 128), ((32, 32, 64), (64, 64, 128), (64, 96, 128))),
    (128, (0.2, 0.4, 0.8), (32, 64, 128), ((64, 64, 128), (128, 128, 256), (128, 128, 256))),
)
P_GROUP_ALL_MLP = (256, 512, 1024)
P_SSG = (512, 0.2, 32, (64, 64, 128))  # pointnet2_cls_ssg.py's SA1, for the poolings and knn
REPO_DIR = pathlib.Path(__file__).resolve().parent


def _nonzero(counts: dict) -> dict:
    return {k: c for k, c in counts.items() if c}


def _graph_targets(program) -> list[str]:
    return [str(node.target) for node in program.graph.nodes if node.op == "call_function"]


def _same_graph(what, program, twin) -> None:
    """Raise unless ``program`` holds ``twin``'s ``gspn::`` ops, as many of
    each, and its ``call_function`` targets in the same order."""
    mine, theirs = _graph_targets(program), _graph_targets(twin)
    gspn = [collections.Counter(t for t in g if t.startswith("gspn.")) for g in (mine, theirs)]
    if gspn[0] != gspn[1] or mine != theirs:
        first = next((i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b),
                     min(len(mine), len(theirs)))
        raise AssertionError(f"(P) {what}: gspn ops {dict(gspn[0])} vs the card's "
                             f"{dict(gspn[1])}; {len(mine)} vs {len(theirs)} calls, first "
                             f"difference at {first}: {mine[first:first + 3]} vs "
                             f"{theirs[first:first + 3]}")


def _ply_vertices(path: pathlib.Path) -> tuple[int, int]:
    """``(vertices, painted)``: the vertex count a PLY file's header
    declares, checked against its lines, and the vertices not in the
    unpainted grey."""
    lines = path.read_text().splitlines()
    count = int(next(x for x in lines if x.startswith("element vertex")).split()[-1])
    body = lines[lines.index("end_header") + 1:]
    if len(body) != count:
        raise AssertionError(f"(P) {path.name}: the header declares {count} vertices, the "
                             "file holds another number")
    return count, sum(not x.endswith(" 128 128 128") for x in body)


def _p_cross_export(work) -> tuple[list, list]:
    """Step 1: starts three exports in child processes that see no card
    (``CUDA_VISIBLE_DEVICES=""``), all at once: ``export_serving
    --platform cuda`` at the flagship, ``--platform cpu,cuda`` at the small
    scene, and :func:`p_thresh_artifact`. Returns the three artifacts'
    paths and the processes."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = [pathlib.Path(work, "p_cross_cuda.gspnt"), pathlib.Path(work, "p_cross_dual.gspnt"),
           pathlib.Path(work, "p_cross_thresh.gspnt")]
    argvs = [P_FLAGSHIP + ["--platform", "cuda", "--out", str(out[0])],
             P_SMALL + ["--platform", "cpu,cuda", "--out", str(out[1])]]
    check = "import torch, sys; assert not torch.cuda.is_available(), 'a card is visible'; "
    procs = [subprocess.Popen([sys.executable, "-c", check + "from gspn_tpu_torch.serve "
                               "import export_serving; export_serving.main(sys.argv[1:])", *argv],
                              cwd=REPO_DIR, env=env) for argv in argvs]
    procs.append(subprocess.Popen([sys.executable, "-c", check + "import chip_smoke; "
                                   "chip_smoke.p_thresh_artifact(sys.argv[1], 'cpu')", str(out[2])],
                                  cwd=REPO_DIR, env=env))
    return out, procs


def p_thresh_artifact(path, device) -> None:
    """The flagship pipeline at (A)'s thresholds (``bench_slice.slice_config()``:
    ``mask_thresh`` 0.49, where the seeded weights' masks are neither empty
    nor full) with ``bench_slice.seeded_model``'s weights on ``device``,
    exported for ``cuda`` by ``serve.export_inference`` (traced on fake
    CUDA tensors when no card is visible) and written to ``path``."""
    from gspn_tpu_torch.serve import export_inference, save_artifact
    from gspn_tpu_torch.utils import bench_slice

    cfg = bench_slice.slice_config()
    program = export_inference(cfg, bench_slice.seeded_model(cfg, device), N, batch_size=B,
                               device="cuda")
    save_artifact(path, program, cfg)


def _p_thresh_check(dev, ops, bench_slice, work, path, total) -> None:
    """Step 4b: the card-less export at ``mask_thresh`` 0.49 against its twin
    exported on the card: equal graphs, and on (A)'s flagship request both
    programs bitwise live ``infer``, with masks neither empty nor full."""
    from gspn_tpu_torch.models.pipeline import PREDICTION_FIELDS, make_inference_fn
    from gspn_tpu_torch.serve import load_artifact
    from gspn_tpu_torch.serve.export import serving_state

    twin = pathlib.Path(work, "p_twin_thresh.gspnt")
    p_thresh_artifact(twin, dev)
    cfg = bench_slice.slice_config()
    model = bench_slice.seeded_model(cfg, dev)
    program, _ = load_artifact(path, dev)
    twin_program, _ = load_artifact(twin, dev)
    _same_graph(f"{path.name} for cuda", program, twin_program)
    xyz, valid, eps = bench_slice.request(cfg, FLAGSHIP, dev, 1)
    sd = serving_state(model)
    with torch.inference_mode():
        live = make_inference_fn(cfg)(model, xyz, valid, z_eps=eps)
        ops.reset_launch_counts()
        got = program.module()(sd, xyz, valid, eps)
        _add_counts(total, ops.launch_counts())
        want = twin_program.module()(sd, xyz, valid, eps)
    for f, g, w in zip(PREDICTION_FIELDS, got, want, strict=True):
        if not (torch.equal(g, w) and torch.equal(g, getattr(live, f))):
            raise AssertionError(f"(P) {path.name}: {f} differs from the card-exported twin's "
                                 "or the live infer's")
    m = got[0][got[4]]
    share = m.float().mean().item() if m.numel() else 0.0
    if not 0.0 < share < 1.0:
        raise AssertionError(f"(P) {path.name} at mask_thresh {cfg.mask_thresh}: "
                             f"{int(got[4].sum())} kept, mask cells {share} set (empty or full)")
    print(f"slice (P) {path.name} (export_inference without a card, mask_thresh "
          f"{cfg.mask_thresh}, B={B} x N={N}): graph == the card-exported twin's; outputs "
          f"bitwise the twin's and live infer's; {int(got[4].sum())} kept, mask cells "
          f"{share:.4f} set (neither empty nor full)")


def _p_artifacts(dev, ops, bench_slice, work, total) -> None:
    """Steps 1-4 of slice (P)."""
    from gspn_tpu_torch.data import synthetic
    from gspn_tpu_torch.models.pipeline import (
        PREDICTION_FIELDS, PipelineModel, init_pipeline_variables, make_inference_fn,
    )
    from gspn_tpu_torch.serve import InferenceSession, load_artifact
    from gspn_tpu_torch.serve import export_serving
    from gspn_tpu_torch.serve.export import serving_state
    from gspn_tpu_torch.serve.runtime import chunk_noise

    t0 = time.perf_counter()
    cross, procs = _p_cross_export(work)
    try:  # the twins are exported on the card while the children trace
        twins = [pathlib.Path(work, "p_twin_cuda.gspnt"), pathlib.Path(work, "p_twin_dual.gspnt")]
        export_serving.main(P_FLAGSHIP + ["--platform", "cuda", "--verify",
                                          "--out", str(twins[0])])
        export_serving.main(P_SMALL + ["--platform", "cpu,cuda", "--verify",
                                       "--out", str(twins[1])])
        twin_s = time.perf_counter() - t0
    finally:
        _wait_ranks("(P) export_serving without a card:", procs, 300)
    print(f"slice (P) export_serving without a card: --platform cuda (B={B} x N={N}) and "
          f"--platform cpu,cuda (B=2 x N=2048), and export_inference at mask_thresh 0.49 "
          f"(B={B} x N={N}), three processes, and the export_serving twins "
          f"with --verify here at the same time: twins {twin_s:.1f} s, all "
          f"{time.perf_counter() - t0:.1f} s")
    small = synthetic.scene_batch(np.random.default_rng(0), 2, n_points=2048)
    _p_thresh_check(dev, ops, bench_slice, work, cross[2], total)
    for label, flags, path, twin, scenes in (
            ("cuda", P_FLAGSHIP, cross[0], twins[0], bench_slice.scenes(FLAGSHIP)),
            ("cpu,cuda", P_SMALL, cross[1], twins[1], (small["xyz"], small["valid"]))):
        cfg = export_serving.build_config(export_serving.parse_args(flags + ["--out", "x"]))
        b, n = scenes[0].shape[:2]
        # the CLI's weights (seed 0, no checkpoint), which its --verify ran
        state = init_pipeline_variables(cfg, torch.Generator().manual_seed(0), n)
        model = PipelineModel(cfg)
        model.load_state_dict(state)
        model = model.to(dev).eval()
        program, manifest = load_artifact(path, dev)
        twin_program, _ = load_artifact(twin, dev)
        if manifest["platforms"] != label.split(","):
            raise AssertionError(f"(P) {path.name}: platforms {manifest['platforms']}")
        _same_graph(f"{path.name} for cuda", program, twin_program)
        xyz, valid = (torch.from_numpy(a).to(dev) for a in scenes)
        eps = chunk_noise(1, 0, (b, cfg.num_seeds, cfg.gspn.latent_dim)).to(dev)
        sd = serving_state(model)
        with torch.inference_mode():
            ops.reset_launch_counts()
            live = make_inference_fn(cfg)(model, xyz, valid, z_eps=eps)
            request = ops.launch_counts()
            if {k for k, c in request.items() if c} != SLICE_KERNELS["A"]:
                raise AssertionError(f"(P) a live request launched {request}")
            ops.reset_launch_counts()
            got = program.module()(sd, xyz, valid, eps)
            if ops.launch_counts() != request:
                raise AssertionError(f"(P) {path.name} eagerly launched {ops.launch_counts()}, "
                                     f"a live request {request}")
            _add_counts(total, ops.launch_counts())
            want = twin_program.module()(sd, xyz, valid, eps)
        ops.reset_launch_counts()
        session = InferenceSession(path, state, device=dev)
        captured = ops.launch_counts()
        if captured != {k: 2 * c for k, c in request.items()}:
            raise AssertionError(f"(P) {path.name}'s session captured with {captured}")
        _add_counts(total, captured)
        ops.reset_launch_counts()
        replayed = session.run(xyz, valid, eps)
        if any(ops.launch_counts().values()):
            raise AssertionError(f"(P) a replay launched {ops.launch_counts()}")
        for way, outs in (("program.module()", got), ("InferenceSession.run", replayed)):
            for f, g, w in zip(PREDICTION_FIELDS, outs, want, strict=True):
                if not (torch.equal(g, w) and torch.equal(g, getattr(live, f))):
                    raise AssertionError(f"(P) {path.name} through {way}: {f} differs from the "
                                         "card-exported artifact's or the live infer's")
        m = got[0][got[4]]
        print(f"slice (P) {path.name} ({label}, B={b} x N={n}): graph == the card's "
              f"({len(_graph_targets(program))} calls, "
              f"{sum(t.startswith('gspn.') for t in _graph_targets(program))} gspn ops); "
              f"eager and replayed outputs bitwise the card-exported twin's and live infer's; "
              f"launches a request {_nonzero(request)}; {int(got[4].sum())} kept, mask cells "
              f"{m.float().mean().item() if m.numel() else 0.0:.3f} set")
        if label == "cpu,cuda":  # step 4: its cpu program on the CPU
            cpu_program, _ = load_artifact(path, "cpu")
            twin_cpu, _ = load_artifact(twin, "cpu")
            _same_graph(f"{path.name} for cpu", cpu_program, twin_cpu)
            cpu_model = model.to("cpu")
            cx, cv, ce = xyz.cpu(), valid.cpu(), eps.cpu()
            with torch.inference_mode():
                cpu_live = make_inference_fn(cfg)(cpu_model, cx, cv, z_eps=ce)
                cpu_got = cpu_program.module()(serving_state(cpu_model), cx, cv, ce)
            for f, g in zip(PREDICTION_FIELDS, cpu_got, strict=True):
                if not torch.equal(g, getattr(cpu_live, f)):
                    raise AssertionError(f"(P) {path.name}'s cpu program: {f} differs from the "
                                         "live CPU pipeline's")
            print(f"slice (P) {path.name}'s cpu program on the CPU (B={b} x N={n}): bitwise "
                  "the live CPU pipeline")


def _p_demo(dev, ops, bench_slice, work, total) -> None:
    """Step 5: ``demo_predict`` at its defaults on the card, then its scene,
    weights and noise through the plain model on the card: the prediction
    PLY byte for byte."""
    from gspn_tpu_torch.eval import demo_predict
    from gspn_tpu_torch.models.pipeline import PipelineModel

    out = pathlib.Path(work, "p_demo")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    gt, pred = demo_predict.main(["--out", str(out)])
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    if {k for k, c in counts.items() if c} != SLICE_KERNELS["A"]:
        raise AssertionError(f"(P) demo_predict launched {counts}")
    _add_counts(total, counts)
    args = demo_predict.parse_args(["--out", str(out)])
    cfg, batch = demo_predict.demo_config(args), demo_predict.load_scene(args)
    n_valid = int(batch["valid"][0].sum())
    (n_gt, gt_painted), (n_pred, painted) = _ply_vertices(gt), _ply_vertices(pred)
    if (n_gt, n_pred) != (n_valid, n_valid) or not (gt_painted and painted):
        raise AssertionError(f"(P) demo_predict's PLY files hold {n_gt} and {n_pred} of its "
                             f"{n_valid} points, {gt_painted} and {painted} painted")
    model = PipelineModel(cfg)
    model.load_state_dict(demo_predict.model_state(cfg, args))
    pcfg, pmodel = bench_slice.plain_model(cfg, model.to(dev).eval())
    ops.reset_launch_counts()
    preds = demo_predict.predict(pcfg, pmodel, batch, dev)
    if any(ops.launch_counts().values()):
        raise AssertionError(f"(P) the demo's plain path launched {ops.launch_counts()}")
    _, plain_pred, kept, _ = demo_predict.write_scene(pathlib.Path(work, "p_demo_plain"), batch,
                                                      preds)
    if plain_pred.read_bytes() != pred.read_bytes():
        raise AssertionError("(P) demo_predict's scene_pred.ply differs from the plain path's")
    print(f"slice (P) demo_predict at its defaults (GSPNConfig(), N=2048, 32 seeds): "
          f"{secs:.1f} s, {n_valid} points a file, {kept} proposals kept painting {painted} "
          f"points (GT {gt_painted}), scene_pred.ply "
          f"byte for byte the plain path's; launches {_nonzero(counts)}")


def _p_library(dev, ops, total) -> torch.Tensor:
    """Step 6: the library modules at PointNet++'s published MSG widths, B=16
    x N=1024 objects: the MSG stack (SA1, SA2, group-all SA3), an SSG SA
    with each pooling and one with knn grouping, each kernel path against
    a plain twin with the same weights. Returns the objects' points."""
    from gspn_tpu_torch.data import synthetic
    from gspn_tpu_torch.nn.layers import glorot_init_
    from gspn_tpu_torch.nn.pointnet2 import POOLINGS, PointNetSAModule, PointNetSAModuleMSG

    seeds = itertools.count(7)

    def pair(build):
        """``build``'s module on the kernels and its plain twin, the same
        seeded weights."""
        kernel, plain = build("auto"), build("plain")
        glorot_init_(kernel, torch.Generator().manual_seed(next(seeds)))
        plain.load_state_dict(kernel.state_dict())
        return kernel.to(dev).eval(), plain.to(dev).eval()

    msg = []
    in_dim = 3
    for npoint, radii, ks, mlps in P_MSG:
        msg.append(pair(lambda impl, a=(in_dim, npoint, radii, ks, mlps): PointNetSAModuleMSG(
            *a, ops_impl=impl)))
        in_dim = 3 + sum(m[-1] for m in mlps)
    msg.append(pair(lambda impl: PointNetSAModule(in_dim, 0, 0.0, 0, P_GROUP_ALL_MLP,
                                                  group_all=True, ops_impl=impl)))
    npoint, radius, k, mlp = P_SSG
    ssg = {p: pair(lambda impl, p=p: PointNetSAModule(3, npoint, radius, k, mlp, pooling=p,
                                                      ops_impl=impl)) for p in POOLINGS}
    ssg["knn"] = pair(lambda impl: PointNetSAModule(3, npoint, radius, k, mlp, use_knn=True,
                                                    ops_impl=impl))
    pts, _ = synthetic.object_batch(np.random.default_rng(0), P_B, P_N)
    xyz = torch.from_numpy(pts.astype(np.float32)).to(dev)

    def run(path):
        outs = []
        x, f = xyz, None
        for mods in msg:
            x, f, _ = mods[path](x, f)
            outs.append((x, f))
        outs += [ssg[name][path](xyz)[:2] for name in ssg]
        torch.cuda.synchronize()
        return outs

    with torch.inference_mode():
        ops.reset_launch_counts()
        ms, kernel = _host_ms(lambda: run(0))
        counts = ops.launch_counts()
        ops.reset_launch_counts()
        plain_ms, plain = _host_ms(lambda: run(1))
    if any(ops.launch_counts().values()):
        raise AssertionError(f"(P) the library modules' plain path launched "
                             f"{ops.launch_counts()}")
    want = {"fps": len(P_MSG) + len(ssg), "ball_group": len(P_MSG) + len(POOLINGS)}
    if {k: c for k, c in counts.items() if c} != want:
        raise AssertionError(f"(P) the library modules launched {counts}, expected {want}")
    _add_counts(total, counts)
    names = ["MSG SA1", "MSG SA2", "SA3 group-all", *(f"SSG {p}" for p in ssg)]
    for name, (kx, kf), (px, pf) in zip(names, kernel, plain, strict=True):
        if not (torch.equal(kx, px) and torch.equal(kf, pf)):
            raise AssertionError(f"(P) {name}: the kernel path's centres or features differ "
                                 "from the plain path's")
    print(f"slice (P) PointNet++ library modules, B={P_B} x N={P_N} objects, MSG widths "
          f"(SA1 -> {tuple(kernel[0][1].shape)}, SA2 -> {tuple(kernel[1][1].shape)}, SA3 -> "
          f"{tuple(kernel[2][1].shape)}) and SSG SA1 with {', '.join(ssg)}: centres and features "
          f"bitwise the plain path's; host ms {ms:.1f} (plain {plain_ms:.1f}); launches "
          f"{_nonzero(counts)}")
    return xyz


def _p_kernel_times(ops, xyz, card) -> None:
    """The two kernels the library modules launch, at the MSG stack's
    shapes (SA1 on the objects, SA2 on SA1's centres), outside any counted
    window: each output bitwise its plain version's, the wrapper's ms (CUDA
    events), the kernel's device ms (``torch.profiler``), the plain
    version's ms and the bound (``_bound``, counted as the kernel phase
    counts fps and the first-K ball group)."""
    pts = xyz
    for sa, (npoint, radii, ks, _) in enumerate(P_MSG, 1):
        b, n = pts.shape[:2]
        q = ops.gather_point(pts, ops.farthest_point_sample(npoint, pts))
        for name, label, fn, work in (
                ("fps", f"(P) MSG SA{sa}: {b} x {n} pts, {npoint} picks",
                 lambda impl, p=pts, k=npoint: ops.farthest_point_sample(k, p, impl=impl),
                 lambda out, p=pts, k=npoint: (_nbytes(p, out), b * (k - 1) * n * 10)),
                ("ball_group", f"(P) MSG SA{sa}: {b} x {npoint} q over {n}, radii {radii}, "
                               f"K {ks}",
                 lambda impl, p=pts, c=q, r=radii, k=ks: ops.query_ball_group_multi(
                     r, k, p, c, None, impl=impl),
                 lambda out, p=pts, c=q, r=radii: (
                     _nbytes(p, c, *tk.flatten(out)),
                     _first_k_tested(out, p.shape[1]) * (8 + len(r))))):
            want = fn("plain")
            err = tk.max_abs_err(tk.flatten(fn("cuda")), tk.flatten(want))
            ms = tk.cuda_ms(lambda fn=fn: fn("cuda"), KERNEL_ITERS)
            plain_ms = tk.cuda_ms(lambda fn=fn: fn("plain"), PLAIN_SLOW_ITERS)
            dev_ms, events = tk.device_ms(lambda fn=fn: fn("cuda"), KERNEL_ITERS,
                                          DEVICE_SYMBOLS[name])
            bound_ms, bound_by = _bound(*work(want))
            dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
            print(f"kernel {name} [{label}]: equal to plain (max abs err {err}); wrapper "
                  f"{ms:.4f} ms (kernel's device time {dev_txt} over {events} of "
                  f"{KERNEL_ITERS} launches), plain {plain_ms:.4f} ms; bound {bound_ms:.5f} ms "
                  f"({bound_by}) [{card}]")
        pts = q


def run_complete_slice(dev, ops, bench_slice, card, work) -> dict:
    """Slice (P): what the port took last. ``export_serving`` run without a
    card (child processes with ``CUDA_VISIBLE_DEVICES=""``) for ``cuda`` at
    the flagship and for ``cpu,cuda`` at a small scene; the same exports on
    the card (``--verify``) as twins: equal graphs (``gspn::`` ops and
    every call in order); the card-less artifacts on the card through
    ``program.module()`` and ``InferenceSession``'s replay, bitwise the
    twins' and live ``infer``'s, with (A)'s launches a request (twice at
    the capture, none at a replay); the dual artifact's cpu program on the
    CPU, bitwise the live CPU pipeline; ``demo_predict`` at its defaults,
    its prediction PLY byte for byte the plain path's; and the PointNet++
    library modules (MSG, group-all, the poolings, knn) against their plain
    twins, then fps and the ball group timed at the MSG shapes. Returns the
    launch counts of every checked run summed."""
    _phase("slice (P)")
    t0 = time.perf_counter()
    total = dict.fromkeys(ops.launch_counts(), 0)
    _p_artifacts(dev, ops, bench_slice, work, total)
    _phase("slice (P) demo_predict")
    _p_demo(dev, ops, bench_slice, work, total)
    _phase("slice (P) library modules")
    xyz = _p_library(dev, ops, total)
    _p_kernel_times(ops, xyz, card)
    print(f"slice (P) {time.perf_counter() - t0:.1f} s [{card}]")
    return total


def _assert_same_training(what, model, other, losses, other_losses) -> None:
    """Raise unless two training runs gave bitwise-equal losses, parameters
    and buffers (BatchNorm running statistics)."""
    if not torch.equal(losses, other_losses):
        raise AssertionError(f"{what}: losses differ: {losses.tolist()} vs "
                             f"{other_losses.tolist()}")
    a, b = model.state_dict(), other.state_dict()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if differ:
        raise AssertionError(f"{what}: {len(differ)} tensors differ, e.g. {differ[:3]}")


def _deterministic_mode_diagnostic(bench_slice, cfg, batch, eps) -> None:
    """One kernel-path training step (a model of its own) under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, switched
    off again right after: prints each operation PyTorch warns about (one
    that has no deterministic implementation on the card)."""
    import warnings

    from gspn_tpu_torch.train.steps import (
        TrainState, make_gspn_loss_fn, make_optimizer, make_train_step,
    )

    model = bench_slice.seeded_gspn(cfg, batch["xyz"].device)
    step = make_train_step(make_gspn_loss_fn(bench_slice.TRAIN_SEEDS, bench_slice.TRAIN_GT))
    state = TrainState(model, make_optimizer(model, 1e-3))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step(state, batch, z_eps=eps)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    found = sorted({str(w.message).strip().splitlines()[0][:200] for w in caught})
    print(f"slice (G) deterministic-mode diagnostic, one step: {len(found)} warnings: "
          f"{json.dumps(found)}")


def _print_ranking(entries, requests, runs) -> None:
    """Where a request loses the most: for each request of the ranked
    slices (a request of (A), (B), (E), (H), a pass of (F), a step of (G)
    and of (I):
    ``requests`` keyed by ``time_kernels.request_key``), each kernel's
    (device ms - bound ms) summed over every launch of that request, each at
    its own shape. Raises unless each slice's launches are its requests'
    taken as often as the slice ran each, kernel for kernel. Kernels no
    ranked request launches follow, by slice: launches a request (or a
    step, or a pass) of their slice x (device ms - bound ms) at their first
    shape."""
    by = {e["name"]: e for e in entries}
    # runs of each request of a slice: (A), (B), (E), (H) at each shape, (F)
    # a pass at each shape, (G) a step; (C) and (D) one shape
    per_run = {"A": REQUESTS + 1, "B": VARIANT_REQUESTS + 1, "C": VARIANT_REQUESTS + 1,
               "D": VARIANT_REQUESTS + 1, "E": VARIANT_REQUESTS + 1, "F": 1,
               "H": VARIANT_REQUESTS + 1, "G": TRAIN_STEPS + 1, "I": TRAIN_STEPS + 1}
    slices = sorted({req.split(")")[0][1:] for req in requests})
    for s in slices:
        mine = {req: launches for req, launches in requests.items() if req.startswith(f"({s}) ")}
        planned = {}
        for launches in mine.values():
            for name, _ in launches:
                planned[name] = planned.get(name, 0) + 1
        # the training BatchNorm's kernels launch at their layers' shapes,
        # which no request lists: they are ranked off the requests
        for name in (SLICE_KERNELS[s] - set(tk.BN_SYMBOLS)) | set(planned):
            if runs[s][name] != planned.get(name, 0) * per_run[s]:
                raise AssertionError(f"{name}: slice ({s}) launched it {runs[s][name]} times, "
                                     f"the ranking counts {planned.get(name, 0)} a run of "
                                     "its requests")
        for req, launches in mine.items():
            lost, missing = {}, []
            for name, label in launches:
                dev_ms = by[name]["device_ms_by_shape"][label]
                if dev_ms is None:
                    missing.append(f"{name} [{label}]")
                    continue
                lost[name] = lost.get(name, 0.0) + dev_ms - by[name]["bound_ms_by_shape"][label]
            unit = {"F": "pass", "G": "step", "I": "step"}.get(s, "request")
            print(f"ms above the bound per {req} {unit}, each of its {len(launches)} launches "
                  f"at its own shape: " + ", ".join(
                      f"{k} {v:.4f}" for k, v in sorted(lost.items(), key=lambda kv: -kv[1]))
                  + f"; total {sum(lost.values()):.4f}"
                  + (f"; not measured: {', '.join(missing)}" if missing else ""))
    ranked = {name for launches in requests.values() for name, _ in launches}
    off = []
    for e in entries:
        if e["name"] in ranked or e["device_ms"] is None:
            continue
        s = e["slice"]
        each = e["launches"] / per_run[s]
        off.append((each * (e["device_ms"] - e["bound_ms"]), e["name"], s, each))
    print("off the ranked slices, by slice (launches a request, step or pass of the slice x ms "
          "above the bound at the first shape): " + (", ".join(
              f"({s}) {name} {each:g} x = {v:.4f}"
              for v, name, s, each in sorted(off, reverse=True)) or "none"))


S_KERNELS = PATH_KERNELS | {"mask_project"} | set(G_PER_STEP) | set(I_PER_STEP)


def _roofline_case(label, fn, cost, peaks, card) -> None:
    """Time ``ROOFLINE_CALLS`` calls of ``fn`` after a warm-up
    (``profile_roofline.timed``: ``time_fn`` of each synchronized call) and
    print ``cost``'s report against ``peaks``."""
    from gspn_tpu_torch.utils import profile_roofline as pr

    rep = pr.report(cost, pr.timed(fn, ROOFLINE_CALLS), peaks)
    print(f"slice (S-roofline) {label}: measured {rep['measured_ms']:.3f} ms (min "
          f"{rep['min_ms']:.3f}, max {rep['max_ms']:.3f}; median of {rep['calls']} after a "
          f"warm-up); floor {rep['floor_ms']:.5f} ms ({rep['bound']}); frac_of_roof "
          f"{rep['frac_of_roof']:.5f}; mfu {rep['mfu']:.6f} against {peaks.name} [{card}]",
          flush=True)


def run_roofline_slice(dev, ops, bench_slice, card, work, entries, model_floors) -> dict:
    """Slice (S-roofline): the model's floors of each stage and the measured
    calls' shares of the card (``utils/roofline.py``,
    ``utils/profile_roofline.py``): (A)'s config at both shapes, eager and
    replayed by an ``InferenceSession``; (L-bf16)'s flagship against the
    bf16 peaks; a (G) and an (I) training step. Then each kernel's model
    floor at its first shape beside ``_bound``'s. Returns the launch
    counts."""
    from gspn_tpu_torch.models.presets import set_pipeline_dtype
    from gspn_tpu_torch.utils import profile_roofline as pr

    _phase("slice (S-roofline)")
    cfg = bench_slice.slice_config()
    bcfg = set_pipeline_dtype(cfg, torch.bfloat16)
    stage1, stage2 = pr.pipeline_config("1"), pr.pipeline_config("2")
    b, n = bench_slice.TRAIN_BATCH, bench_slice.TRAIN_POINTS
    cases = [  # (label, config, stage, B, N, way)
        (f"(A) flagship B={B} x N={N}", cfg, "infer", B, N, ("eager", "session")),
        (f"(A) whole scene B=1 x N={WS_N} (10 % padding)", cfg, "infer", 1, WS_N,
         ("eager", "session")),
        (f"(L-bf16) flagship B={B} x N={N}", bcfg, "infer", B, N, ("eager",)),
        (f"(G) stage-1 step B={b} x N={n}", stage1, "1", b, n, ("step",)),
        (f"(I) stage-2 step B={b} x N={n}", stage2, "2", b, n, ("step",)),
    ]
    ops.reset_launch_counts()
    for label, ccfg, stage, cb, cn, ways in cases:
        peaks = pr.peaks_for(ccfg)
        stages = pr.stage_costs(ccfg, stage, cb, cn, bench_slice.TRAIN_GT)
        print(f"slice (S-roofline) {label} floors:\n  "
              + "\n  ".join(pr.floor_lines(stages, peaks)))
        for way in ways:
            fn = (pr.step_fn(ccfg, stage, cb, cn, dev, bench_slice.TRAIN_GT) if way == "step"
                  else pr.request_fn(ccfg, cb, cn, dev, way, work))
            name = {"eager": "eager infer", "session": "InferenceSession.run",
                    "step": "a training step"}[way]
            _roofline_case(f"{label}, {name}", fn, stages["total"], peaks, card)
    counts = ops.launch_counts()
    launched = {k for k, c in counts.items() if c}
    if launched != S_KERNELS:
        raise AssertionError(f"slice (S-roofline) launched {sorted(launched)}, expected "
                             f"{sorted(S_KERNELS)}")
    print(f"slice (S-roofline) launches: {json.dumps(counts)}")
    for e in entries:
        model = model_floors.get(e["name"])
        if model is None:
            print(f"slice (S-roofline) kernel {e['name']}: no model floor (utils/roofline.py "
                  "prices no BatchNorm kernel)")
            continue
        floor_ms = model["floor"] * 1e3
        ratio = floor_ms / e["bound_ms"] if e["bound_ms"] else float("inf")
        mark = f" (differ by more than {ROOFLINE_GAP:g}x)" if not (
            1 / ROOFLINE_GAP <= ratio <= ROOFLINE_GAP) else ""
        print(f"slice (S-roofline) kernel {e['name']} [{next(iter(e['bound_ms_by_shape']))}]: "
              f"model floor {floor_ms:.5f} ms ({model['bound']}), _bound "
              f"{e['bound_ms']:.5f} ms ({e['bound_by']}), model / _bound {ratio:.3f}{mark}")
    return counts


def run_sanitize_slice(card) -> None:
    """Slice (S-sanitize): ``utils/debug.py --sanitize`` under
    compute-sanitizer's memcheck, racecheck, synccheck and initcheck at
    once (only the port's kernels checked); any report fails. Where the
    machine has no compute-sanitizer, or it answers "Device not supported"
    for a program that runs no kernel of the port
    (``debug.sanitizer_usable``), the phase is left out and says why; any
    other failure of that probe fails."""
    from gspn_tpu_torch.utils import debug

    _phase("slice (S-sanitize)")
    path = debug.sanitizer_path()
    if path is None:
        print("slice (S-sanitize): left out: no compute-sanitizer on this machine (PATH, "
              "$CUDA_HOME/bin, /usr/local/cuda/bin)")
        return
    version = subprocess.run([path, "--version"], capture_output=True, text=True)
    version = version.stdout.strip().splitlines()[-1]
    usable, why = debug.sanitizer_usable()
    if not usable:
        print(f"slice (S-sanitize): left out: {path} ({version}) cannot check this card; "
              f"under memcheck a program that runs no kernel of the port answers: {why} "
              f"[{card}]")
        return
    print(f"slice (S-sanitize): {path}, {version}")
    t0 = time.perf_counter()
    results = debug.run_under(debug.SANITIZER_TOOLS)
    failed = []
    for tool, r in results.items():
        done = next((ln for ln in r["output"].splitlines() if ln.startswith(debug.SANITIZE_DONE)),
                    "not done")
        print(f"slice (S-sanitize) {tool}: {'clean' if r['ok'] else 'FAILED'}, exit {r['rc']} "
              f"in {r['seconds']:.1f} s; {done}; {r['summary']} [{card}]", flush=True)
        if not r["ok"]:
            failed.append(tool)
            print(r["output"][-12000:])
    if failed:
        raise AssertionError(f"slice (S-sanitize): compute-sanitizer reported under {failed}")
    print(f"slice (S-sanitize): every kernel on each path clean under "
          f"{', '.join(debug.SANITIZER_TOOLS)} in {time.perf_counter() - t0:.1f} s")


def run_serving_process(work) -> tuple[dict, dict]:
    """Slice (J) in a process of its own (this script with ``--serving
    WORK``), waited for: its profiler windows count device operations
    exactly only in a process whose CUPTI has not yet dropped records,
    which the kernel phase's long library calls make it do. Returns
    ``run_serving``'s result."""
    _phase("slice (J)")
    subprocess.run([sys.executable, __file__, "--serving", str(work)], check=True, timeout=600)
    res = json.loads((pathlib.Path(work) / "serving.json").read_text())
    return res["captures"], res["per_request"]


def _serving_main(work) -> None:
    """The ``--serving WORK`` process: slice (J), its result in
    ``WORK/serving.json``."""
    from gspn_tpu_torch import ops
    from gspn_tpu_torch.ops import _cuda
    from gspn_tpu_torch.utils import bench_slice

    bench_slice.pin_float32_matmuls()
    _cuda.library()
    captures, per_request = run_serving(torch.device("cuda", 0), ops, bench_slice,
                                        tk.card_name(), work)
    (pathlib.Path(work) / "serving.json").write_text(json.dumps(
        {"captures": captures, "per_request": per_request}))


def main() -> None:
    if sys.argv[1:2] == ["--serving"]:
        _serving_main(sys.argv[2])
        return
    if sys.argv[1:2] == ["--dp-rank"]:
        _dp_rank_main(sys.argv[2])
        return
    if sys.argv[1:2] == ["--ps-rank"]:
        _ps_rank_main(sys.argv[2])
        return
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    card = tk.card_name()
    from gspn_tpu_torch import ops
    from gspn_tpu_torch.ops import _cuda
    from gspn_tpu_torch.utils import bench_slice

    _phase("device")
    nvcc = subprocess.run([_cuda.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{nvcc.splitlines()[-1]}")
    bench_slice.pin_float32_matmuls()

    _phase("build")
    lib, secs = _cuda.build()
    _cuda.library()
    print(f"build: {lib.name} in {secs:.1f} s")

    dev = torch.device("cuda", 0)
    entries, requests, model_floors = check_kernels(dev, ops, bench_slice)
    runs = run_slices(dev, ops, bench_slice, card)
    with tempfile.TemporaryDirectory() as work:
        runs["G"] = run_training(dev, ops, bench_slice, card, work)
        runs["I"] = run_stage2(dev, ops, bench_slice, card, work)
        runs["K"] = run_eval_slice(dev, ops, bench_slice, card, work)
        runs.update(run_knob_slice(dev, ops, bench_slice, card, work, runs["A"]))
        runs["M"] = run_data_slice(dev, ops, bench_slice, card, work)
        runs["N"] = run_dp_slice(dev, ops, bench_slice, card, work)
        runs["O"] = run_point_sharded_slice(dev, ops, bench_slice, card, work)
        runs["P"] = run_complete_slice(dev, ops, bench_slice, card, work)
        runs["Q"] = run_options_slice(dev, ops, bench_slice, card, work)
        runs["R"] = run_train_knobs_slice(dev, ops, bench_slice, card, work)
        runs["S"] = run_roofline_slice(dev, ops, bench_slice, card, work, entries,
                                           model_floors)
        run_sanitize_slice(card)
        runs["J"], per_request = run_serving_process(work)
    a_request = {k: c / (2 * (REQUESTS + 1)) for k, c in runs["A"].items()}
    if a_request != per_request:
        raise AssertionError(f"(J)'s captures took a request's launches as {per_request}, "
                             f"(A)'s requests launched {a_request} each")
    for e in entries:
        e["slice"] = next(s for s, c in runs.items() if c[e["name"]])
        e["launches"] = runs[e["slice"]][e["name"]]
        e["launches_by_slice"] = {s: c[e["name"]] for s, c in runs.items()}
    _phase("report")
    _print_ranking(entries, requests, runs)
    print(json.dumps({"kernels": entries}))
    print(f"chip_smoke: total {time.perf_counter() - _T0:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
