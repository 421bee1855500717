"""Stream ms of a step's backward (train.backward, events on the stream; idle
inside it included)."""

from bench_h100 import program_spans


def read(ctx):
    return program_spans.mean(ctx, "train", "train.backward@stream")
