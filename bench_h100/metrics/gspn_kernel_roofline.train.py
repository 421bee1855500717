"""The point ops' least time (workcount) over the hand-written kernels' device time (%)."""

from bench_h100 import readers


def read(ctx):
    return readers.kernel_roofline(ctx, "train")
