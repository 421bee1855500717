"""Device ms a step in the hand-written kernels (gspn::)."""

from bench_h100 import readers


def read(ctx):
    return readers.device_ms(ctx, "train", "gspn_s")
