"""Host ms a request in predict's serve.inputs spans: checks, padding, host-to-
card copies, the noise draw."""

from bench_h100 import program_spans


def read(ctx):
    return program_spans.per(ctx, "serve", "serve.inputs", "serve.predict")
