"""PointNet++ building blocks (shared MLPs, set abstraction, feature
propagation): the PyTorch counterpart of ``gspn_tpu.nn``."""
