"""Stream ms of stage 2's frozen proposals a step: shared FPS, frozen GSPN,
proposal_boxes (train.proposals)."""

from bench_h100 import program_spans


def read(ctx):
    return program_spans.mean(ctx, "train", "train.proposals@stream")
