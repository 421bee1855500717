"""Seconds InferenceSession's set-up takes (serve.open): the artifact's load,
the state to the card, the graph's warm-up and capture."""

from bench_h100 import program_spans


def read(ctx):
    return program_spans.per(ctx, "serve", "serve.open", "serve.open", scale=1.0)
