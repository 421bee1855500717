"""Host ms a training step takes to enqueue its work (train.step)."""

from bench_h100 import program_spans


def read(ctx):
    return program_spans.per(ctx, "train", "train.step", "train.step")
