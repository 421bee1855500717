"""Measurement helpers for the PyTorch port (the counterpart of
``gspn_tpu.utils``)."""
