"""Data-parallel training over a ``torch.distributed`` process group: the
PyTorch counterpart of the data-parallel half of ``gspn_tpu.parallel``
(``make_mesh``, ``shard_batch``, ``replicate``, ``make_dp_train_step``,
``make_dp_inference``). The point-sharded half is not ported."""

from gspn_tpu_torch.parallel.dp import make_dp_inference, make_dp_train_step
from gspn_tpu_torch.parallel.mesh import DataMesh, make_mesh, replicate, shard_batch

__all__ = [
    "DataMesh",
    "make_dp_inference",
    "make_dp_train_step",
    "make_mesh",
    "replicate",
    "shard_batch",
]
