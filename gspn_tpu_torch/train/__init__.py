"""GSPN stage-1 training (the PyTorch counterpart of ``gspn_tpu.train``):
step factories, schedules, checkpoints, metrics and the ``train_gspn``
entry point."""
