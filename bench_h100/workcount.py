"""The benchmark's frozen count of the work a request or a training step
needs, and the card's peaks it is priced at.

Two counts, both taken while the plain reference (``reference/``) runs on
the cell's own inputs, so they follow from the configuration, the shapes
and the data, and never from which implementation of an op the program
ran:

- matrix FLOPs: ``2 * rows * in * out`` for every Dense product the model
  needs (the MLPs, the FC heads), forward only; a training step counts its
  forward products three times (the forward, the input gradient and the
  weight gradient) for the layers that take a gradient, once for the
  frozen network's. ``mfu`` divides it by the float32 matmul peak.
- the point ops, one item a call of an op that the program runs as a
  hand-written kernel (FPS, the ball and box groups, three_nn, the FP
  interpolation, the mask projection, NMS, the chamfer's nearest
  neighbours, a gather's backward): the bytes it must move (each input
  read once, each output written once) and its float32 operations (an
  add, multiply or compare each). Its least time is the larger of bytes
  over the HBM bandwidth and operations over the element-wise peak; the
  kernels' roofline divides the sum by their measured device time.

The operation counts are those the work needs, not those an algorithm
happens to do: FPS a distance pass a pick (10 operations a point), a
first-K group the points up to each query's K-th hit (the data decides
how far a scan must read) at 8 operations a distance and one compare a
scale, a box group 6 compares a point tested, three_nn 9 a pair, the FP
interpolation 5 a channel of three neighbours plus 11 a row for its
weights, the 1-NN mask projection 9 a (point, sample) pair, NMS 20 a pair
of boxes (the pairwise IoU and its compare), the chamfer pair 10 a pair
(one distance, a compare each way), a gather's backward one add a term.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
MATMUL_F32_FLOPS = 67e12  # float32 on the CUDA cores (TF32 off)
ELEMENTWISE_F32_OPS = 33.5e12  # one float32 op a lane and clock, 132 SMs x 128 lanes
HBM_BYTES_PER_S = 3.35e12

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("bench_h100_tally", default=None)


@dataclasses.dataclass
class Tally:
    """What one counted block of the reference needed."""

    matmul_flops: float = 0.0
    # (op, bytes, operations) a call
    point_ops: list = dataclasses.field(default_factory=list)
    # a training step's forward products count three times (see module doc)
    grad_factor: int = 1

    def point_op_least_s(self) -> float:
        """The sum over the calls of each call's least time on the card."""
        return sum(max(b / HBM_BYTES_PER_S, o / ELEMENTWISE_F32_OPS)
                   for _, b, o in self.point_ops)


@contextlib.contextmanager
def counting(grad_factor: int = 1):
    """Count the work of the reference's calls inside the block; yields the
    :class:`Tally`."""
    tally = Tally(grad_factor=grad_factor)
    token = _ACTIVE.set(tally)
    try:
        yield tally
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def frozen_products():
    """Products inside the block take no gradient: counted once."""
    tally = _ACTIVE.get()
    if tally is None:
        yield
        return
    saved, tally.grad_factor = tally.grad_factor, 1
    try:
        yield
    finally:
        tally.grad_factor = saved


def matmul(rows: int, cin: int, cout: int) -> None:
    tally = _ACTIVE.get()
    if tally is not None:
        tally.matmul_flops += 2.0 * rows * cin * cout * tally.grad_factor


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def point_op(name: str, nbytes_: float, ops: float) -> None:
    tally = _ACTIVE.get()
    if tally is not None:
        tally.point_ops.append((name, float(nbytes_), float(ops)))


def counting_on() -> bool:
    return _ACTIVE.get() is not None
