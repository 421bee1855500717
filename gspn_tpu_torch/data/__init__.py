"""Synthetic scene data (the PyTorch port's counterpart of
``gspn_tpu.data``)."""
