"""Host ms a request copies its outputs to numpy (serve.fetch: .cpu() and .numpy())."""

from bench_h100 import program_spans


def read(ctx):
    return program_spans.per(ctx, "serve", "serve.fetch", "serve.predict")
