"""Share of the profiled window with no device operation running (%)."""

from bench_h100 import readers


def read(ctx):
    return readers.idle_share(ctx, "serve")
