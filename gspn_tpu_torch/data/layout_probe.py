"""Host-side layout-bias probe for first-K grouping: the port's own copy
of ``gspn_tpu/data/layout_probe.py`` (NumPy only).

The reference's ball query / in-box sampling take the FIRST K candidates
in input order (SURVEY.md §2.1 ``query_ball_point`` — load-bearing
replicate-first semantics). The round-4 mechanism study (STATUS.md
"Morton layout is a QUALITY loser") measured that on spatially-coherent
raw layouts (Morton / scan order) the first K candidates of a ball are
its z-order-lowest corner: the subsample's spatial spread drops to
0.68-0.86 of the full candidate set's, and AP collapses (0.248 -> 0.029
on Morton-sorted synthetic scenes). On shuffled / instance-ordered
layouts the ratio is ~1.0 and first-K is unbiased.

``layout_bias_probe`` computes that spread ratio on a host batch so
drivers (run_eval, the trainers) can WARN when the data layout is in the
measured pathology regime and recommend the subsample-robust
``--group-select strided`` mode (ops/ball_query.py).
"""

from __future__ import annotations

import numpy as np

# measured regime (STATUS.md round-4): raw instance-ordered scenes probe
# ~1.0 at every radius; Morton-sorted scenes probe 0.68-0.86
SPREAD_WARN_THRESHOLD = 0.92
# striding only matters when balls actually overflow K
OVERFLOW_WARN_FRACTION = 0.25


def layout_bias_probe(
    xyz: np.ndarray,
    valid: np.ndarray | None = None,
    radius: float = 0.5,
    k: int = 64,
    n_queries: int = 32,
    seed: int = 0,
) -> dict:
    """Spread ratio of the first-K-in-index-order subsample vs the full
    candidate set, over random valid query balls of one or more scenes.

    Args:
      xyz: (B, N, 3) or (N, 3) host array.
      valid: matching (B, N) / (N,) bool mask.
      radius: probe ball radius (use a model context/SA radius).
      k: the grouping budget being probed (e.g. nsample).
      n_queries: query balls sampled per scene.

    Returns a dict with:
      ``spread_ratio`` — mean over probed balls of
        std(first-K candidates) / std(all candidates) (1.0 = unbiased;
        the measured Morton pathology reads 0.68-0.86);
      ``overflow_fraction`` — fraction of probed balls with more than
        ``k`` candidates (striding is a no-op on the rest);
      ``n_probed`` — balls that had > k candidates and entered the ratio;
      ``biased`` — True when both thresholds trip (warn + recommend
        ``select="strided"``).
    """
    x = np.asarray(xyz, np.float32)
    if x.ndim == 2:
        x = x[None]
    b, n, _ = x.shape
    v = np.ones((b, n), bool) if valid is None else np.asarray(valid, bool)
    if v.ndim == 1:
        v = v[None]
    rng = np.random.default_rng(seed)
    ratios = []
    overflow = 0
    probed_balls = 0
    for bi in range(b):
        vidx = np.flatnonzero(v[bi])
        if len(vidx) == 0:
            continue
        qs = rng.choice(vidx, size=min(n_queries, len(vidx)), replace=False)
        pts = x[bi][v[bi]]  # candidates scan valid points in input order
        for q in qs:
            d2 = np.sum((pts - x[bi, q]) ** 2, axis=-1)
            hits = np.flatnonzero(d2 < radius * radius)
            probed_balls += 1
            if len(hits) <= k:
                continue
            overflow += 1
            full = pts[hits]
            first = pts[hits[:k]]
            s_full = float(np.mean(np.std(full, axis=0)))
            s_first = float(np.mean(np.std(first, axis=0)))
            if s_full > 1e-9:
                ratios.append(s_first / s_full)
    ratio = float(np.mean(ratios)) if ratios else 1.0
    overflow_frac = overflow / max(probed_balls, 1)
    return {
        "spread_ratio": round(ratio, 4),
        "overflow_fraction": round(overflow_frac, 4),
        "n_probed": len(ratios),
        "biased": bool(
            ratios
            and ratio < SPREAD_WARN_THRESHOLD
            and overflow_frac > OVERFLOW_WARN_FRACTION
        ),
    }


def warn_if_layout_biased(
    batch: dict, radius: float = 0.5, k: int = 64, where: str = "",
) -> dict:
    """Run the probe on a host batch dict (keys ``xyz`` / ``valid``) and
    print a warning when the layout is in the measured first-K pathology
    regime. Returns the probe dict (callers can log it)."""
    res = layout_bias_probe(
        np.asarray(batch["xyz"]),
        np.asarray(batch["valid"]) if "valid" in batch else None,
        radius=radius,
        k=k,
    )
    if res["biased"]:
        print(
            f"WARNING{': ' + where if where else ''}: point layout is "
            f"spatially coherent (first-K spread ratio "
            f"{res['spread_ratio']} over {res['n_probed']} probe balls, "
            f"{res['overflow_fraction']:.0%} overflowing K={k}) — "
            "first-K grouping is measurably biased on such layouts "
            "(STATUS.md round-4 mechanism study; AP collapsed to 0.03 "
            "on Morton-sorted scenes). Consider --group-select strided.",
            flush=True,
        )
    return res
