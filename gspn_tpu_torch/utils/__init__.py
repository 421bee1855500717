"""Measurement helpers for the PyTorch port (the counterpart of
``gspn_tpu.utils``)."""

from gspn_tpu_torch.utils.timing import sync, time_fn

__all__ = ["sync", "time_fn"]
