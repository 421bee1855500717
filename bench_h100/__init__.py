"""The port's benchmark on an NVIDIA H100: ``run.py`` runs one cell (see
``README.md``)."""
