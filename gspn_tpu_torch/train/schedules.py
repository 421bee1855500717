"""Learning-rate and BatchNorm-momentum schedules: the PyTorch counterpart
of ``gspn_tpu/train/schedules.py``, as plain ``step -> value`` functions of
the update count before the step.

The JAX package applies the momentum schedule after the step, re-blending
the running statistics its layers updated at ``BN_MOMENTUM``. The port sets
each ``MaskedBatchNorm``'s ``momentum`` before the step instead
(``train/steps.py``), so the layers update at the scheduled momentum
directly; the two agree up to rounding.
"""

from __future__ import annotations

import math


def build_lr_schedule(args):
    """``step -> lr`` from the trainer's flags (``lr``, ``lr_schedule``,
    ``lr_decay_steps``, ``lr_decay_rate``, ``lr_min``, ``steps``), as optax
    computes them: ``constant``; ``exp``, the staircase
    ``exponential_decay`` floored at ``lr_min``; ``cosine``,
    ``cosine_decay_schedule`` over ``steps`` with ``alpha = lr_min / lr``."""
    kind = getattr(args, "lr_schedule", "constant")
    lr = args.lr
    if kind == "constant":
        return lambda step: lr
    if kind == "exp":
        every, rate, floor = args.lr_decay_steps, args.lr_decay_rate, args.lr_min

        def exp(step):
            if every <= 0 or rate == 0:
                return lr
            value = lr if step <= 0 else lr * rate ** math.floor(step / every)
            return max(value, floor) if rate < 1.0 else min(value, floor)
        return exp
    if kind == "cosine":
        total = max(args.steps, 1)
        alpha = args.lr_min / args.lr

        def cosine(step):
            decay = 0.5 * (1 + math.cos(math.pi * min(step, total) / total))
            return lr * ((1 - alpha) * decay + alpha)
        return cosine
    raise ValueError(f"unknown lr schedule {kind!r}")


def bn_momentum_schedule(init_decay: float = 0.5, decay_steps: int = 10000,
                         decay_rate: float = 0.5, clip: float = 0.99):
    """The reference's ``get_bn_decay``: ``momentum(step) = min(clip, 1 -
    init_decay * decay_rate ** (step // decay_steps))``."""

    def momentum(step):
        return min(clip, 1.0 - init_decay * decay_rate ** math.floor(step / decay_steps))

    return momentum
