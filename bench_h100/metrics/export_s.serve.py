"""Seconds export_inference takes (serve.export), a call."""

from bench_h100 import program_spans


def read(ctx):
    return program_spans.per(ctx, "serve", "serve.export", "serve.export", scale=1.0)
