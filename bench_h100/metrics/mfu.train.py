"""The model's matrix FLOPs a step over the float32 matmul peak's work in its time (%)."""

from bench_h100 import readers


def read(ctx):
    return readers.mfu(ctx, "train")
