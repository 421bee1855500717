"""Host ms a request waits for its own device work (serve.device_wait, an event
after the clones)."""

from bench_h100 import program_spans


def read(ctx):
    return program_spans.per(ctx, "serve", "serve.device_wait", "serve.predict")
