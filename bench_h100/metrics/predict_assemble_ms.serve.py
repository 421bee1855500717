"""Host ms a request joins its chunks' outputs (serve.assemble: np.concatenate)."""

from bench_h100 import program_spans


def read(ctx):
    return program_spans.per(ctx, "serve", "serve.assemble", "serve.predict")
