"""How ``correct`` is decided: the numbers that hold the program's outputs
against the plain reference's, each beside the limit the cell's file
``limits/<cell>.json`` states. ``PERF.md`` gives the readings each limit
was set from."""

from __future__ import annotations

import numpy as np
import torch


# a score or a box coordinate that moved by more than this counts as moved:
# some hundred float32 rounding steps of a score near 0.05, of a coordinate
# near 4 m (the widest gaps are no number of their own: a point on a box's
# face moves a RoI's samples now and then, in float32 too)
SCORE_MOVED = 1e-6
BOX_MOVED = 1e-5


class ServeCheck:
    """Accumulates a served request's answers against the reference's:

    - ``slot_mismatch``: share of proposal slots whose validity differs, or
      that both keep with different classes;
    - ``mask_mismatch``: share of mask cells that differ, over the cells of
      the slots either side keeps;
    - ``score_moved``: share of the slots both keep whose score differs by
      more than ``SCORE_MOVED``;
    - ``box_moved``: share of the refined box coordinates of the slots both
      keep that differ by more than ``BOX_MOVED`` metres."""

    def __init__(self):
        self.slots = self.slot_bad = 0
        self.cells = self.cell_bad = 0
        self.both = self.score_bad = self.box_bad = 0
        self.score_gap = self.box_gap = 0.0
        self.requests = self.kept = self.set_cells = 0

    def add(self, got: dict, want: dict) -> None:
        w = {k: v.cpu().numpy() for k, v in want.items()}
        gv, wv = np.asarray(got["valid"], bool), w["valid"].astype(bool)
        both = gv & wv
        either = gv | wv
        self.slots += gv.size
        self.slot_bad += int((gv != wv).sum() + (both & (got["classes"] != w["classes"])).sum())
        n = got["masks"].shape[-1]
        self.cells += int(either.sum()) * n
        self.cell_bad += int((got["masks"] != w["masks"])[either].sum())
        ds = np.abs(got["scores"] - w["scores"])[both]
        db = np.abs(got["boxes"] - w["boxes"])[both]
        self.both += int(both.sum())
        self.score_bad += int((ds > SCORE_MOVED).sum())
        self.box_bad += int((db > BOX_MOVED).sum())
        if both.any():
            self.score_gap = max(self.score_gap, float(ds.max()))
            self.box_gap = max(self.box_gap, float(db.max()))
        self.requests += 1
        self.kept += int(wv.sum())
        self.set_cells += int(w["masks"].sum())

    def summary(self) -> str:
        """What the check saw (an all-empty answer would compare blind), and
        the widest score and box gaps."""
        return (f"{self.requests} requests checked: the reference keeps {self.kept} of "
                f"{self.slots} slots, {self.set_cells} mask cells set; widest score gap "
                f"{self.score_gap!r}, box gap {self.box_gap!r}")

    def numbers(self) -> dict:
        return {
            "slot_mismatch": self.slot_bad / max(self.slots, 1),
            "mask_mismatch": self.cell_bad / max(self.cells, 1),
            "score_moved": self.score_bad / max(self.both, 1),
            "box_moved": self.box_bad / max(self.both * 6, 1),
        }


def _median(xs):
    return float(np.median(np.asarray(xs, np.float64)))


def train_numbers(losses: list[float], ref_losses: list[float], grads: dict, ref_grads: dict,
                  change: dict, ref_change: dict, stats: dict, ref_stats: dict) -> dict:
    """A training cell's numbers over its first three steps:

    - ``loss_gap``: the largest relative difference of a step's loss;
    - ``first_loss_gap``: the relative difference of the first step's loss
      (the steps after it start from parameters that rounding has already
      moved apart, and a near-tie that this flips moves their losses);
    - ``grad_norm_gap``: the worst leaf's gap between the norms of the
      first gradient (the program's as its optimizer received it), over
      the larger of the reference leaf's norm and the median leaf's;
    - ``change_gap``: the same for the norm of each parameter's change
      over the three steps, leaving out the leaves whose first reference
      gradient is under a thousandth of the median leaf's (their moves
      under Adam are round-off);
    - ``bn_stat_gap``: the same for each BatchNorm running statistic's
      change."""

    def worst(got: dict, want: dict, keys) -> float:
        keys = list(keys)
        wn = {k: float(want[k].double().norm()) for k in keys}
        gn = {k: float(got[k].double().norm()) for k in keys}
        med = _median(list(wn.values()))
        return max(abs(gn[k] - wn[k]) / max(wn[k], med, 1e-30) for k in keys)

    gnorm = {k: float(v.double().norm()) for k, v in ref_grads.items()}
    gmed = _median(list(gnorm.values()))
    moving = [k for k in ref_change if gnorm.get(k, 0.0) >= 1e-3 * gmed]
    return {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, ref_losses)),
        "first_loss_gap": abs(losses[0] - ref_losses[0]) / max(abs(ref_losses[0]), 1e-30),
        "grad_norm_gap": worst(grads, ref_grads, ref_grads),
        "change_gap": worst(change, ref_change, moving),
        "bn_stat_gap": worst(stats, ref_stats, ref_stats),
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(every limited number within its limit, {name: {"value",
    "limit"}})``; a number that is not finite fails. A cell compares the
    numbers its limits file lists."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers[name]
        good = bool(np.isfinite(value)) and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out


def to_cpu(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", torch.float64) for k, v in tensors.items()}
