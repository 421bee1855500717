"""An analytic model of the least work a request or a training step needs,
and the least time an NVIDIA H100 could take for it: the counterpart of
``gspn_tpu/utils/roofline.py``, with the same builders and formulas.

Every hot op of the pipeline has static shapes, so its work follows from
the config: each builder gives a :class:`Cost` of three counts, and
:meth:`Cost.floors` divides each by the card's peak for it (a
:class:`Peaks`). The largest quotient is the floor no implementation can
beat, and names the roof the work sits under. ``profile_roofline`` prints
the floors beside measured times; ``report``'s ``frac_of_roof`` and
``mfu`` are the shares of a whole request or step against the card.

The three counts keep the JAX package's names; on this card they are:

- ``mxu_flops``: the FLOPs of matrix products (2 an FMA). The roof is
  the rate the port's matmuls run at: float32 with TF32 off
  (``bench_slice.pin_float32_matmuls``), 67 TFLOP/s on the CUDA cores
  (:data:`H100_SXM`); bfloat16 on the tensor cores, 989 TFLOP/s dense
  (:data:`H100_SXM_BF16`).
- ``vpu_ops``: element-wise float32 operations (an add, multiply, compare
  or select each), 33.5 T/s: one instruction a lane and clock on 132 SMs
  x 128 lanes at 1.98 GHz. The kernels build with ``-fmad=false``, so
  none of their adds and multiplies is fused into an FMA.
- ``hbm_bytes``: each tensor read once and written once at 4 bytes an
  element (also where a knob computes in bfloat16, as the JAX model
  counts them), at 3.35 TB/s of HBM3. A kernel that reads an input
  again, or an intermediate written out, raises the real traffic above
  this floor, never below.

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit; a
card set below it runs slower, so every measured share names the card's
power limit beside it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peaks:
    name: str
    mxu_flops: float  # matrix-product FLOP/s at the working type
    vpu_ops: float  # float32 element-wise op/s
    hbm_bytes: float  # device memory bytes/s


H100_SXM = Peaks("H100 SXM, float32 (TF32 off)", 67e12, 33.5e12, 3.35e12)
H100_SXM_BF16 = Peaks("H100 SXM, bfloat16 tensor cores", 989e12, 33.5e12, 3.35e12)


@dataclasses.dataclass
class Cost:
    mxu_flops: float = 0.0
    vpu_ops: float = 0.0
    hbm_bytes: float = 0.0

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(
            self.mxu_flops + o.mxu_flops,
            self.vpu_ops + o.vpu_ops,
            self.hbm_bytes + o.hbm_bytes,
        )

    def floors(self, peaks: Peaks = H100_SXM) -> dict:
        """Per-roof time floors (seconds) and the binding roof."""
        t = {
            "mxu": self.mxu_flops / peaks.mxu_flops,
            "vpu": self.vpu_ops / peaks.vpu_ops,
            "hbm": self.hbm_bytes / peaks.hbm_bytes,
        }
        bound = max(t, key=t.get)
        return {**t, "floor": t[bound], "bound": bound}

    def report(self, measured_s: float, peaks: Peaks = H100_SXM) -> dict:
        """Floors and the shares reached in ``measured_s`` seconds:
        ``frac_of_roof``, the floor over the measured time; ``mfu``, the
        matrix FLOPs over what the matmul roof does in that time."""
        f = self.floors(peaks)
        return {
            **f,
            "measured": measured_s,
            "frac_of_roof": f["floor"] / measured_s if measured_s else 0.0,
            "mfu": (
                self.mxu_flops / (measured_s * peaks.mxu_flops)
                if measured_s
                else 0.0
            ),
        }


# ---------------------------------------------------------------------------
# Cost builders (shapes static; formulas as the JAX package's)
# ---------------------------------------------------------------------------

_B = 4  # f32 bytes


def mlp_cost(rows: int, cin: int, widths, extra_in: int = 0) -> Cost:
    """Shared-MLP / FC stack applied to ``rows`` independent rows: matrix
    FLOPs ``2 * rows * sum(cin_i * cout_i)``; bytes, the input read and the
    final output written once (bias, BatchNorm and ReLU fused into the
    products, the weights negligible); ~4 element-wise ops an output
    element a layer (bias, BatchNorm scale and shift, ReLU)."""
    c = Cost()
    ci = cin + extra_in
    for w in widths:
        c.mxu_flops += 2.0 * rows * ci * w
        c.vpu_ops += 4.0 * rows * w
        ci = w
    c.hbm_bytes += rows * (cin + extra_in + ci) * _B
    return c


def fps_cost(b: int, n: int, npoint: int) -> Cost:
    """Greedy FPS: ``npoint`` dependent picks, each a pass over the row's
    ``n`` points of ~20 ops (the last pick's coordinates, the distance,
    the running minimum, the argmax)."""
    return Cost(
        vpu_ops=20.0 * b * n * npoint,
        hbm_bytes=(b * n * 4 + b * npoint) * _B,
    )


def ball_group_cost(
    b: int,
    m: int,
    n: int,
    nsamples,
    nw: int = 128,
    scan_frac: float = 1.0,
    extract_infl: float = 2.0,
) -> Cost:
    """Multi-scale ball query and group of ``m`` queries over ``n``
    points: a distance pass over the scanned points (~9 ops, ~3 more a
    scale for the hit tests; ``scan_frac`` of the points scanned), and the
    TPU kernel's extraction, ~12 passes over a window of ``nw`` points a
    hit and ``extract_infl`` for its worst row, which the JAX model
    counts and a CUDA scan that appends hits as it finds them does not
    do; the bytes: the points and queries read, each scale's indices and
    local coordinates written."""
    scanned = n * scan_frac
    c = Cost(vpu_ops=(9.0 + 3.0 * len(nsamples)) * b * m * scanned)
    for k in nsamples:
        c.vpu_ops += 12.0 * nw * extract_infl * k * b * m
        c.hbm_bytes += b * m * k * 4 * _B  # idx + 3 local-coord planes
    c.hbm_bytes += b * n * 4 * _B + b * m * 4 * _B
    return c


def three_nn_cost(b: int, n: int, m: int) -> Cost:
    """Brute-force 3-NN: the distance (8 ops) and the running top 3 (~12)
    a (target, source) pair."""
    return Cost(
        vpu_ops=20.0 * b * n * m,
        hbm_bytes=(b * n * 3 + b * m * 3 + b * n * 6) * _B,
    )


def interpolate_mm_cost(b: int, n: int, m: int, c: int) -> Cost:
    """The JAX package's interpolation as a dense product, ``W (N, Mpad) @
    pts (Mpad, Cpad)`` a scene (M and C padded to 128), building ``W`` at
    ~6 ops an element; the port's ``interp_mm`` reads three source rows a
    target instead (5 ops a channel), far less work."""
    mpad = ((m + 127) // 128) * 128
    cpad = ((c + 127) // 128) * 128
    return Cost(
        mxu_flops=2.0 * b * n * mpad * cpad,
        vpu_ops=6.0 * b * n * mpad,
        hbm_bytes=b * (n * 3 * 2 + m * c + n * c) * _B,
    )


def gather_cost(rows: int, c: int) -> Cost:
    """A row gather (``group_point`` / ``gather_point``, or its backward):
    bound by bytes; ~2 ops an element of address arithmetic."""
    return Cost(vpu_ops=2.0 * rows * c, hbm_bytes=2.0 * rows * c * _B)


def nms_cost(b: int, r: int, jacobi_steps: int = 16) -> Cost:
    """The IoU matrix (B, R, R) at ~20 ops a pair, the score sort (~log2(r)
    passes) and ``jacobi_steps`` fixpoint sweeps of ~4 ops a pair (the JAX
    package's form; the port's kernel sweeps the bitmask once)."""
    return Cost(
        vpu_ops=b * r * r * (20.0 + 4.0 * jacobi_steps)
        + b * r * max(r.bit_length(), 1) * 4.0,
        hbm_bytes=b * r * 8.0 * _B,
    )


def mask_project_cost(b: int, r: int, n: int, s: int) -> Cost:
    """A (RoI, point) pair: the inside-box test (~12 ops) and the nearest
    of the RoI's ``s`` samples (5 ops a sample)."""
    return Cost(
        vpu_ops=b * r * n * (12.0 + 5.0 * s),
        hbm_bytes=b * (r * n + n * 3 + r * s * 4) * _B,
    )


def chamfer_cost(rows: int, n: int, m: int) -> Cost:
    """The chamfer loss's nearest neighbours both ways over ``rows`` pairs
    of ``n`` and ``m`` points: the (n, m) distances (~20 ops a pair) each
    way, the points read and their gradients written (the JAX model's
    stage-1 "chamfer loss" term)."""
    return Cost(
        vpu_ops=2.0 * 20.0 * rows * n * m,
        hbm_bytes=rows * (n + m) * 3 * 2 * _B,
    )


# ---------------------------------------------------------------------------
# Whole-pipeline model
# ---------------------------------------------------------------------------


def pipeline_cost(cfg, b: int, n: int) -> dict[str, Cost]:
    """Per-stage Cost of one inference request of ``cfg`` (a
    ``PipelineConfig``) at batch ``b`` x ``n`` points. Returns {stage:
    Cost} plus key 'total'."""
    g, r = cfg.gspn, cfg.rpointnet
    s = cfg.num_seeds
    fdim = g.feature_dim
    stages: dict[str, Cost] = {}

    sa1_p = r.sa_layers[0].npoint
    stages["fps(shared seeds+sa1)"] = fps_cost(b, n, max(s, sa1_p))

    # GSPN: multi-scale context crops + per-scale encoder + CVAE + generator
    c = ball_group_cost(b, s, n, g.context_nsample)
    for k in g.context_nsample:
        c = c + mlp_cost(b * s * k, 3 + fdim, g.encoder_mlp)
        c = c + mlp_cost(b * s * k, 3 + fdim, g.center_mlp)
    rows = b * s
    c = c + mlp_cost(rows, len(g.context_nsample) * g.encoder_mlp[-1], g.center_fc + (3,))
    c = c + mlp_cost(rows, len(g.context_nsample) * g.encoder_mlp[-1], (g.cond_dim,))
    c = c + mlp_cost(rows, g.cond_dim + g.latent_dim, g.generator_fc + (g.num_gen_points * 3,))
    c = c + mlp_cost(rows, g.cond_dim, g.objectness_fc + (1,))
    stages["gspn forward"] = c

    stages["nms"] = nms_cost(b, s)

    # backbone SA stack
    xs_n = n
    cin = 3 + fdim
    for i, spec in enumerate(r.sa_layers):
        c = ball_group_cost(b, spec.npoint, xs_n, (spec.nsample,))
        if i > 0:
            c = c + gather_cost(b * spec.npoint * spec.nsample, cin - 3)
        c = c + mlp_cost(b * spec.npoint * spec.nsample, cin, spec.mlp)
        if i > 0:  # sa2+ re-run fps on the previous level's points
            c = c + fps_cost(b, xs_n, spec.npoint)
        stages[f"sa{i + 1}"] = c
        xs_n = spec.npoint
        cin = spec.mlp[-1] + 3
    # FP stack, as the backbone runs it: fp_mlps[0] first at the deepest
    # target level (the last SA level's points are its sources), fp_mlps[-1]
    # last at the N points; the source channels chain (the last SA level's,
    # then each FP's mlp[-1]), the skip channels are the target level's
    nsa = len(r.sa_layers)
    lvl_n = [n] + [sp.npoint for sp in r.sa_layers]
    lvl_c = [3 + fdim] + [sp.mlp[-1] for sp in r.sa_layers]
    src_c = lvl_c[-1]
    for i, mlp in enumerate(r.fp_mlps):
        lvl = nsa - 1 - i  # target level (the model's fp{i+1})
        tgt, src = lvl_n[lvl], lvl_n[lvl + 1]
        c = three_nn_cost(b, tgt, src)
        c = c + interpolate_mm_cost(b, tgt, src, src_c)
        c = c + mlp_cost(b * tgt, src_c + lvl_c[lvl], mlp)
        stages[f"fp{i + 1}"] = c
        src_c = mlp[-1]

    # RoI align + heads + mask projection (per-point features: the last
    # FP's output width)
    feat_c = r.fp_mlps[-1][-1]
    rois = s
    c = gather_cost(b * rois * r.roi_samples, feat_c + 3)
    c = c + mlp_cost(b * rois * r.roi_samples, feat_c + 3, r.roi_mlp)
    pooled = r.roi_mlp[-1]
    c = c + mlp_cost(b * rois, pooled, r.cls_fc + (r.num_classes + 1,))
    c = c + mlp_cost(b * rois, pooled, r.box_fc + (6,))
    c = c + mlp_cost(b * rois * r.roi_samples, r.roi_mlp[-1], r.mask_mlp + (1,))
    stages["roi+heads"] = c
    stages["mask project"] = mask_project_cost(b, rois, n, r.roi_samples)

    total = Cost()
    for v in stages.values():
        total = total + v
    stages["total"] = total
    return stages


# ---------------------------------------------------------------------------
# Training-step model
# ---------------------------------------------------------------------------


def _with_grad(c: Cost) -> Cost:
    """Forward and backward of a stage with parameters: the input and
    weight gradients double the matrix FLOPs (3x in all), activations are
    read again and gradients written (~3x the bytes), and the element-wise
    work about triples."""
    return Cost(3.0 * c.mxu_flops, 3.0 * c.vpu_ops, 3.0 * c.hbm_bytes)


def _adam_cost(params: float) -> Cost:
    """An Adam update: ~10 ops a parameter; the parameters, both moments
    and the gradient read, the parameters and moments written (~7
    tensors)."""
    return Cost(vpu_ops=10.0 * params, hbm_bytes=7.0 * params * _B)


def _mlp_params(cin: int, widths) -> float:
    p, ci = 0.0, cin
    for w in widths:
        p += ci * w + 3.0 * w  # kernel + bias + BN scale/shift
        ci = w
    return p


def train_step_cost(cfg, b: int, n: int, gt_size: int = 256,
                    stage: int = 1) -> dict[str, Cost]:
    """Per-stage Cost of one training step (``train/steps.py``) at batch
    ``b`` x ``n`` points. ``stage`` 1: the GSPN CVAE (context crops,
    recognition net, chamfer and KL losses, Adam); 2: R-PointNet over a
    frozen GSPN's proposals (the frozen forward without a backward, the
    backbone and heads with one). The index ops (FPS, the ball queries'
    structure, NMS) take no gradient. The backward is the usual 3x of
    the matrix work: floors, not exact counts."""
    g, r = cfg.gspn, cfg.rpointnet
    s = cfg.num_seeds
    fdim = g.feature_dim
    infer = pipeline_cost(cfg, b, n)
    stages: dict[str, Cost] = {}

    if stage == 1:
        stages["fps(seeds)"] = fps_cost(b, n, s)
        # the crops' structure takes no gradient: only the MLP share of
        # infer's "gspn forward" (which holds the ball group too) does
        crops = ball_group_cost(b, s, n, g.context_nsample)
        mlps = infer["gspn forward"] + Cost(
            -crops.mxu_flops, -crops.vpu_ops, -crops.hbm_bytes
        )
        stages["context crops"] = crops
        stages["gspn mlps fwd+bwd"] = _with_grad(mlps)
        # recognition net: encodes the GT instance set (training only)
        stages["recognition net"] = _with_grad(
            mlp_cost(b * s * gt_size, 3, g.encoder_mlp)
        )
        # chamfer: both directions of the (generated, GT) distances
        stages["chamfer loss"] = chamfer_cost(b * s, g.num_gen_points, gt_size)
        params = (
            len(g.context_nsample)
            * (_mlp_params(3 + fdim, g.encoder_mlp)
               + _mlp_params(3 + fdim, g.center_mlp))
            + _mlp_params(len(g.context_nsample) * g.encoder_mlp[-1],
                          g.center_fc + (3,))
            + 2 * _mlp_params(len(g.context_nsample) * g.encoder_mlp[-1],
                              (g.cond_dim,))
            + _mlp_params(g.cond_dim + g.latent_dim,
                          g.generator_fc + (g.num_gen_points * 3,))
            + _mlp_params(g.cond_dim, g.objectness_fc + (1,))
        )
        stages["adam"] = _adam_cost(params)
    else:
        # frozen GSPN proposals: forward only
        stages["fps(shared)"] = infer["fps(shared seeds+sa1)"]
        stages["frozen gspn fwd"] = infer["gspn forward"]
        # backbone + heads: fwd + bwd
        for name in list(infer):
            if name.startswith(("sa", "fp")) or name == "roi+heads":
                stages[f"{name} fwd+bwd"] = _with_grad(infer[name])
        # fg/bg matching: IoU of (R rois x I instances) boxes
        stages["roi matching"] = Cost(vpu_ops=20.0 * b * (2 * s) * 32)
        params = 0.0
        cin = 3 + fdim
        for spec in r.sa_layers:
            params += _mlp_params(cin, spec.mlp)
            cin = spec.mlp[-1] + 3
        lvl_c = [3 + fdim] + [sp.mlp[-1] for sp in r.sa_layers]
        src_c = lvl_c[-1]
        for i, mlp in enumerate(r.fp_mlps):
            params += _mlp_params(src_c + lvl_c[len(r.sa_layers) - 1 - i], mlp)
            src_c = mlp[-1]
        params += _mlp_params(r.fp_mlps[-1][-1] + 3, r.roi_mlp)
        pooled = r.roi_mlp[-1]
        params += _mlp_params(pooled, r.cls_fc + (r.num_classes + 1,))
        params += _mlp_params(pooled, r.box_fc + (6,))
        params += _mlp_params(r.roi_mlp[-1], r.mask_mlp + (1,))
        stages["adam"] = _adam_cost(params)

    total = Cost()
    for v in stages.values():
        total = total + v
    stages["total"] = total
    return stages
