"""Launches of the hand-written gspn:: kernels a training step (ops/_cuda.py
counters over train.step)."""

from bench_h100 import program_spans


def read(ctx):
    return program_spans.launches_per(ctx, "train", "train.step")
