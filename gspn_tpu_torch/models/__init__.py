"""GSPN, R-PointNet, the inference pipeline and presets (the PyTorch
counterpart of ``gspn_tpu.models``)."""
