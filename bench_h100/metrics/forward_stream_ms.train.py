"""Stream ms of a step's forward and loss (train.forward, events on the stream;
idle inside it included)."""

from bench_h100 import program_spans


def read(ctx):
    return program_spans.mean(ctx, "train", "train.forward@stream")
