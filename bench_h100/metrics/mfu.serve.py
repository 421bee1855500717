"""The model's matrix FLOPs a request over the float32 matmul peak's work in its time (%)."""

from bench_h100 import readers


def read(ctx):
    return readers.mfu(ctx, "serve")
