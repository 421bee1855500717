"""The end-to-end arithmetic: rates over the whole window and tails over
every request."""

from __future__ import annotations

import math


def rate(amount: float, seconds: float) -> float:
    """Work a second over the whole window, stalls included."""
    if seconds <= 0:
        raise ValueError("the window must have a length")
    return amount / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of every value (nearest rank: the smallest
    value with at least ``q`` % of the values at or below it)."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return s[k - 1]

