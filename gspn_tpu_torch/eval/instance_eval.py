"""Instance-segmentation AP — ScanNet benchmark protocol (host side).

The port's own copy of ``gspn_tpu/eval/instance_eval.py``: the same NumPy
code and results bit for bit, with :func:`predictions_from_device` taking
the port's predictions (torch tensors, or a serving session's tuple or
dict).

The reference vendors/invokes the official ScanNet
``evaluate_semantic_instance`` scripts (SURVEY.md §2.2, inference and
eval). This module implements the same protocol from its public
definition: per-class, per-IoU-threshold greedy matching of
score-descending predictions to GT instances (each GT matched at most
once), then area under the interpolated precision-recall curve. Reported
metrics: AP@0.25, AP@0.5, and AP averaged over thresholds 0.5:0.95:0.05,
as on the benchmark.

Host-side NumPy by design — evaluation consumes dumped predictions and is
not on the training/inference hot path (same as the reference).
"""

from __future__ import annotations

import dataclasses

import numpy as np

OVERLAPS_AP = np.arange(0.5, 1.0, 0.05)


@dataclasses.dataclass
class ScenePredictions:
    """One scene's predictions: masks (R, N) bool, scores (R,), classes (R,)."""

    masks: np.ndarray
    scores: np.ndarray
    classes: np.ndarray


@dataclasses.dataclass
class SceneGT:
    """One scene's ground truth: per-point instance ids (0 = none) and the
    semantic class of each instance id. ``void_mask`` marks unannotated
    points (the official evaluator forgives predictions that mostly cover
    void); None = no void anywhere."""

    inst_label: np.ndarray  # (N,) i32
    inst_class: dict[int, int]  # instance id -> semantic class
    void_mask: np.ndarray | None = None  # (N,) bool


def _mask_iou(pred_mask: np.ndarray, gt_mask: np.ndarray) -> float:
    inter = np.logical_and(pred_mask, gt_mask).sum()
    union = np.logical_or(pred_mask, gt_mask).sum()
    return float(inter) / float(union) if union > 0 else 0.0


@dataclasses.dataclass
class _SceneClassStats:
    """One (scene, class)'s overlap-threshold-independent matching inputs:
    nothing else about the scene is consulted during matching, so
    resampling scenes (bootstrap) can resample THESE instead of re-running
    every ``_mask_iou`` per replicate (a ~n_boot x eval speedup)."""

    n_gt: int
    scores: list[float]  # this class's predictions, scene order
    iou: np.ndarray  # (P, n_gt) IoU vs each kept GT instance
    vfrac: list[float]  # per-pred void fraction (incl. small-GT void)


def _scene_class_stats(
    pred: ScenePredictions, gt: SceneGT, cls: int, min_region_size: int
) -> _SceneClassStats:
    void = (
        gt.void_mask.copy()
        if gt.void_mask is not None
        else np.zeros_like(gt.inst_label, bool)
    )
    masks = []
    for iid, icls in gt.inst_class.items():
        if icls == cls and iid > 0:
            m = gt.inst_label == iid
            if min_region_size > 0 and m.sum() < min_region_size:
                void |= m
            else:
                masks.append(m)
    sel = np.where(pred.classes == cls)[0]
    scores = [float(pred.scores[pi]) for pi in sel]
    iou = np.zeros((len(sel), len(masks)))
    vfrac = []
    for a, pi in enumerate(sel):
        pm = pred.masks[pi]
        for j, gm in enumerate(masks):
            iou[a, j] = _mask_iou(pm, gm)
        size = int(pm.sum())
        vfrac.append(float((pm & void).sum()) / size if size else 0.0)
    return _SceneClassStats(
        n_gt=len(masks), scores=scores, iou=iou, vfrac=vfrac
    )


def _compute_stats(
    predictions, ground_truths, class_ids, min_region_size
) -> list[dict[int, _SceneClassStats]]:
    return [
        {
            cls: _scene_class_stats(pred, gt, cls, min_region_size)
            for cls in class_ids
        }
        for pred, gt in zip(predictions, ground_truths, strict=True)
    ]


def _average_precision(tp: np.ndarray, fp: np.ndarray, n_gt: int) -> float:
    """All-point interpolated AP (precision envelope), the standard used by
    the ScanNet evaluator."""
    if n_gt == 0:
        return float("nan")
    if len(tp) == 0:
        return 0.0
    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-12)
    # precision envelope
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_instances(
    predictions: list[ScenePredictions],
    ground_truths: list[SceneGT],
    class_ids: list[int],
    overlaps: np.ndarray | None = None,
    min_region_size: int = 0,
    void_forgive: bool = False,
    match: str = "greedy",
    _stats: list[dict[int, _SceneClassStats]] | None = None,
) -> dict:
    """AP per class per overlap, plus the benchmark summary numbers.

    Official-protocol knobs (all default to the round-1 behavior so
    existing numbers stay comparable; the official ScanNet evaluator uses
    ``min_region_size=100, void_forgive=True, match="per_gt"``):

    - ``min_region_size``: GT instances smaller than this many points are
      excluded from the GT set; their points join the void region, so
      predictions covering them are forgiven rather than penalized.
    - ``void_forgive``: an unmatched prediction whose fraction of points
      on void/unannotated regions (``SceneGT.void_mask`` plus excluded
      small same-class instances) exceeds the overlap threshold being
      evaluated is ignored (neither TP nor FP) — the official evaluator's
      void-overlap exclusion rule.
    - ``match``: duplicate-prediction resolution. ``"greedy"`` resolves in
      global score order (each pred takes its max-IoU unmatched GT).
      ``"per_gt"`` is the official rule: iterate GT instances; among
      not-yet-matched predictions strictly above the IoU threshold, the
      highest-confidence one becomes the GT's single TP (and only IT is
      marked matched); the rest are appended as FPs at their own
      confidences but stay available — a duplicate FP for one GT can
      still become the TP of a later GT (and a never-matched duplicate is
      appended once per GT it exceeds the threshold on), exactly as the
      official evaluator's greedy per-GT assignment behaves when its
      per-GT prediction lists are score-ordered. Both modes use the
      official strict ``iou > threshold`` hit predicate.

    Returns dict with 'ap' (mAP 0.5:0.95), 'ap_50', 'ap_25', and
    'per_class' {class_id: {'ap': ..., 'ap_50': ..., 'ap_25': ...}}.
    """
    if match not in ("greedy", "per_gt"):
        raise ValueError(f"match must be greedy|per_gt, got {match!r}")
    assert len(predictions) == len(ground_truths)
    all_overlaps = np.unique(
        np.concatenate([overlaps if overlaps is not None else OVERLAPS_AP, [0.25, 0.5]])
    )
    # per-(scene, class) matching inputs — IoU matrices, void fractions,
    # kept-GT counts. Everything below consumes ONLY these, so callers
    # that resample scenes (bootstrap_ci / bootstrap_diff) precompute them
    # once and pass resampled lists via ``_stats`` instead of paying the
    # full mask-IoU cost per replicate.
    if _stats is None:
        _stats = _compute_stats(
            predictions, ground_truths, class_ids, min_region_size
        )
    # ap_table[class][overlap] = AP
    ap_table: dict[int, dict[float, float]] = {c: {} for c in class_ids}

    for cls in class_ids:
        st = [s[cls] for s in _stats]
        n_gt = sum(x.n_gt for x in st)

        if match == "per_gt":
            # official rule: per-scene score-descending pred lists (the
            # stable sort matches the old global-sort-then-bucket order)
            orders = [
                np.argsort(
                    -np.asarray(x.scores, dtype=np.float64), kind="stable"
                )
                for x in st
            ]
            for ov in all_overlaps:
                y_true: list[int] = []
                y_score: list[float] = []
                for si, x in enumerate(st):
                    order = orders[si]
                    iou = x.iou[order] if len(order) else x.iou
                    scs = [x.scores[a] for a in order]
                    vfr = [x.vfrac[a] for a in order]
                    used = np.zeros(len(order), bool)
                    for j in range(x.n_gt):
                        above = [
                            a
                            for a in range(len(order))
                            if not used[a] and iou[a, j] > ov
                        ]
                        if not above:
                            continue  # hard false negative (counted via n_gt)
                        # the list is score-descending, so above[0] is the
                        # max-confidence candidate: it becomes the TP and
                        # is the ONLY one marked matched (official rule);
                        # lower-confidence duplicates are FPs at their own
                        # confidence but stay available for later GTs.
                        y_true.append(1)
                        y_score.append(scs[above[0]])
                        used[above[0]] = True
                        for a in above[1:]:
                            y_true.append(0)
                            y_score.append(scs[a])
                    # remaining unmatched preds: the official found_gt
                    # re-check — a pred with any above-threshold overlap
                    # was already appended as a duplicate FP in the GT
                    # loop, so only overlap-free preds are counted here
                    for a in range(len(order)):
                        if used[a]:
                            continue
                        if any(iou[a, j] > ov for j in range(x.n_gt)):
                            continue  # duplicate FP, already appended
                        if void_forgive and vfr[a] > ov:
                            continue  # ignored
                        y_true.append(0)
                        y_score.append(scs[a])
                order = np.argsort(-np.asarray(y_score, dtype=np.float64), kind="stable")
                yt = np.asarray(y_true)[order] if len(y_true) else np.zeros(0)
                ap_table[cls][float(ov)] = _average_precision(
                    yt, 1 - yt, n_gt
                )
            continue

        # greedy (score-descending) matching across scenes: the stable
        # sort reproduces the original insertion order (scene, pred) on
        # score ties. IoUs don't depend on the matched state, so the
        # per-entry IoU row and void fraction come straight from _stats.
        entries = []  # (score, scene_idx, row_in_stats)
        for si, x in enumerate(st):
            for a, sc in enumerate(x.scores):
                entries.append((sc, si, a))
        entries.sort(key=lambda e: -e[0])
        for ov in all_overlaps:
            matched = [np.zeros(x.n_gt, bool) for x in st]
            tp = np.zeros(len(entries))
            fp = np.zeros(len(entries))
            for ei, (_, si, a) in enumerate(entries):
                ious = np.where(matched[si], -1.0, st[si].iou[a])
                best_j = int(np.argmax(ious)) if len(ious) else -1
                best_iou = float(ious[best_j]) if best_j >= 0 else 0.0
                if best_j >= 0 and best_iou > ov:  # official strict >
                    matched[si][best_j] = True
                    tp[ei] = 1
                else:
                    if void_forgive and st[si].vfrac[a] > ov:
                        continue  # ignored: neither TP nor FP
                    fp[ei] = 1
            ap_table[cls][float(ov)] = _average_precision(tp, fp, n_gt)

    def _mean(vals):
        vals = [v for v in vals if not np.isnan(v)]
        return float(np.mean(vals)) if vals else float("nan")

    per_class = {
        c: {
            "ap": _mean([ap_table[c][float(o)] for o in OVERLAPS_AP]),
            "ap_50": ap_table[c][0.5],
            "ap_25": ap_table[c][0.25],
        }
        for c in class_ids
    }
    return {
        "ap": _mean([per_class[c]["ap"] for c in class_ids]),
        "ap_50": _mean([per_class[c]["ap_50"] for c in class_ids]),
        "ap_25": _mean([per_class[c]["ap_25"] for c in class_ids]),
        "per_class": per_class,
    }


def bootstrap_ci(
    predictions: list[ScenePredictions],
    ground_truths: list[SceneGT],
    class_ids: list[int],
    n_boot: int = 100,
    seed: int = 0,
    ci: float = 0.95,
    **eval_kwargs,
) -> dict:
    """Scene-level bootstrap confidence intervals for the AP summary.

    Matching in both ``evaluate_instances`` modes is scene-local (only the
    cross-scene pooled PR curve couples scenes), so resampling SCENES with
    replacement is the natural bootstrap unit: it models "how would the
    number move on a different draw of evaluation scenes", which is the
    question the 16-scene synthetic A/Bs kept running into (deltas of
    ±0.05 AP between configs are routinely inside the resampling noise).

    Returns ``{"ap": (lo, hi), "ap_50": (lo, hi), "ap_25": (lo, hi)}`` at
    the ``ci`` percentile level, computed over ``n_boot`` replicates with
    a deterministic ``seed``. NaN replicates (a resample can drop every
    scene containing some class — the per-class mean then shrinks its
    class set, not NaN; a fully empty resample is impossible since n>=1)
    are excluded per-field.
    """
    assert len(predictions) == len(ground_truths)
    n = len(predictions)
    if n == 0 or n_boot <= 0:
        nan = (float("nan"), float("nan"))
        return {"ap": nan, "ap_50": nan, "ap_25": nan}
    rng = np.random.default_rng(seed)
    # mask IoUs / void fractions are per-scene and threshold-independent:
    # compute them ONCE and resample the stats, not the masks (~n_boot x
    # cheaper; bit-identical results)
    stats = _compute_stats(
        predictions, ground_truths, class_ids,
        eval_kwargs.get("min_region_size", 0),
    )
    samples: dict[str, list[float]] = {"ap": [], "ap_50": [], "ap_25": []}
    for _ in range(n_boot):
        idx = rng.integers(0, n, size=n)
        res = evaluate_instances(
            [predictions[i] for i in idx],
            [ground_truths[i] for i in idx],
            class_ids,
            _stats=[stats[i] for i in idx],
            **eval_kwargs,
        )
        for k in samples:
            samples[k].append(res[k])
    lo_q, hi_q = 100 * (1 - ci) / 2, 100 * (1 + ci) / 2
    out = {}
    for k, vals in samples.items():
        v = np.asarray(vals, dtype=np.float64)
        v = v[~np.isnan(v)]
        if len(v) == 0:
            out[k] = (float("nan"), float("nan"))
        else:
            out[k] = (
                float(np.percentile(v, lo_q)),
                float(np.percentile(v, hi_q)),
            )
    return out


def bootstrap_diff(
    predictions_a: list[ScenePredictions],
    predictions_b: list[ScenePredictions],
    ground_truths: list[SceneGT],
    class_ids: list[int],
    n_boot: int = 100,
    seed: int = 0,
    ci: float = 0.95,
    **eval_kwargs,
) -> dict:
    """PAIRED scene-level bootstrap of the AP difference (A - B).

    For config A/Bs on the SAME scenes (e.g. two FPS settings on one
    checkpoint), two independent :func:`bootstrap_ci` intervals waste
    power: the scene draw is shared, so most of each arm's variance is
    common and cancels in the difference. Here every replicate resamples
    ONE scene index set and applies it to BOTH arms, giving the CI of
    the per-draw delta — the statistic that actually answers "is A
    better than B on scenes like these".

    Returns ``{"ap_diff": (lo, hi), "ap_50_diff": ..., "ap_25_diff": ...,
    "ap_diff_mean": ..., ...}``. A CI excluding 0 is a significant
    difference at the ``ci`` level.
    """
    assert len(predictions_a) == len(predictions_b) == len(ground_truths)
    n = len(ground_truths)
    if n == 0 or n_boot <= 0:
        nan = (float("nan"), float("nan"))
        return {f"{k}_diff": nan for k in ("ap", "ap_50", "ap_25")}
    rng = np.random.default_rng(seed)
    mrs = eval_kwargs.get("min_region_size", 0)
    stats_a = _compute_stats(predictions_a, ground_truths, class_ids, mrs)
    stats_b = _compute_stats(predictions_b, ground_truths, class_ids, mrs)
    samples: dict[str, list[float]] = {"ap": [], "ap_50": [], "ap_25": []}
    for _ in range(n_boot):
        idx = rng.integers(0, n, size=n)
        gts = [ground_truths[i] for i in idx]
        res_a = evaluate_instances(
            [predictions_a[i] for i in idx], gts, class_ids,
            _stats=[stats_a[i] for i in idx], **eval_kwargs,
        )
        res_b = evaluate_instances(
            [predictions_b[i] for i in idx], gts, class_ids,
            _stats=[stats_b[i] for i in idx], **eval_kwargs,
        )
        for k in samples:
            samples[k].append(res_a[k] - res_b[k])
    lo_q, hi_q = 100 * (1 - ci) / 2, 100 * (1 + ci) / 2
    out = {}
    for k, vals in samples.items():
        v = np.asarray(vals, dtype=np.float64)
        v = v[~np.isnan(v)]
        if len(v) == 0:
            out[f"{k}_diff"] = (float("nan"), float("nan"))
            out[f"{k}_diff_mean"] = float("nan")
        else:
            out[f"{k}_diff"] = (
                float(np.percentile(v, lo_q)),
                float(np.percentile(v, hi_q)),
            )
            out[f"{k}_diff_mean"] = float(np.mean(v))
    return out


def predictions_from_device(preds, scene_valid=None) -> list[ScenePredictions]:
    """Per-scene host predictions from a batch of the port's predictions,
    dropping invalid proposal slots and (with ``scene_valid (B, N)``)
    padded points. ``preds`` is an ``InstancePredictions`` of tensors on any
    device, the ``(masks, scores, classes, boxes, valid)`` tuple
    ``InferenceSession.run`` returns, or the dict of numpy arrays of
    ``InferenceSession.predict``; each field is copied to the host once."""
    if isinstance(preds, dict):
        fields = preds
    elif isinstance(preds, tuple):
        fields = dict(zip(("masks", "scores", "classes", "boxes", "valid"), preds, strict=True))
    else:
        fields = {f: getattr(preds, f) for f in ("masks", "scores", "classes", "valid")}
    masks, scores, classes, valid = (_host(fields[f]) for f in ("masks", "scores", "classes",
                                                                  "valid"))
    scene_valid = None if scene_valid is None else _host(scene_valid)
    out = []
    for bi in range(masks.shape[0]):
        keep = valid[bi]
        m = masks[bi][keep]
        if scene_valid is not None:
            m = m[:, scene_valid[bi]]
        out.append(
            ScenePredictions(
                masks=m, scores=scores[bi][keep], classes=classes[bi][keep]
            )
        )
    return out


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a NumPy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def gt_from_labels(inst_label: np.ndarray, sem_label: np.ndarray) -> SceneGT:
    """Build SceneGT from per-point instance + semantic label arrays.
    Points with no semantic annotation (label <= 0) form the void region."""
    inst_class = {}
    for iid in np.unique(inst_label):
        if iid <= 0:
            continue
        members = inst_label == iid
        inst_class[int(iid)] = int(np.bincount(sem_label[members]).argmax())
    return SceneGT(
        inst_label=inst_label,
        inst_class=inst_class,
        void_mask=np.asarray(sem_label) <= 0,
    )
