"""The data sources (the PyTorch port's counterpart of ``gspn_tpu.data``):
synthetic scenes and objects, ScanNet crops from preprocessed scans
(``scannet``, ``preprocess_scannet``), ShapeNet objects and PartNet parts
from h5 files, and the host point-prep library (``native``)."""
