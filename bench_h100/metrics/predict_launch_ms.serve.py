"""Host ms a request holds the lock (serve.launch): the graph's input copies,
replay and output clones."""

from bench_h100 import program_spans


def read(ctx):
    return program_spans.per(ctx, "serve", "serve.launch", "serve.predict")
