"""Host ms a request waits for the session's lock (serve.lock_wait): its queue
behind other clients' replays."""

from bench_h100 import program_spans


def read(ctx):
    return program_spans.per(ctx, "serve", "serve.lock_wait", "serve.predict")
