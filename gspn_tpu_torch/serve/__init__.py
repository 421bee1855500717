"""Serving: the exported inference artifact and its runtime.

The port's counterpart of ``gspn_tpu.serve``. ``export`` traces the fused
pipeline (``models/pipeline.py::make_inference_fn``: seeds, GSPN, NMS,
RoIAlign, heads, mask projection) once with ``torch.export`` into a
single-file artifact; ``runtime`` serves it from a session, on the card as
one CUDA graph a request, behind a socket server that speaks the JAX
package's wire protocol. The command lines are ``python -m
gspn_tpu_torch.serve.export_serving`` and ``python -m
gspn_tpu_torch.serve.serve_gspnx``.
"""

from gspn_tpu_torch.serve.export import export_inference, load_artifact, save_artifact
from gspn_tpu_torch.serve.runtime import (
    Client,
    InferenceSession,
    Server,
    pipeline_config_from_manifest,
    session_from_checkpoints,
)

__all__ = [
    "Client",
    "InferenceSession",
    "Server",
    "export_inference",
    "load_artifact",
    "pipeline_config_from_manifest",
    "save_artifact",
    "session_from_checkpoints",
]
