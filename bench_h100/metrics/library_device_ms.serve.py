"""Device ms a request in PyTorch's own kernels (outside the gspn namespace, copies aside)."""

from bench_h100 import readers


def read(ctx):
    return readers.device_ms(ctx, "serve", "library_s")
