"""Parallelism over ``torch.distributed`` process groups: the PyTorch
counterpart of ``gspn_tpu.parallel``. Data parallelism splits the batch
over the ranks (``make_mesh``, ``shard_batch``, ``replicate``,
``make_dp_train_step``, ``make_dp_inference``); point sharding splits the
work inside each scene over the ranks of a row of a 2-D mesh
(``make_mesh_2d``): the backbone's points (``make_sharded_backbone``), the
seeds and RoIs of inference (``make_point_sharded_inference``,
``make_spatial_inference``) and of both training stages
(``make_point_sharded_gspn_train_step``,
``make_point_sharded_rpointnet_train_step``)."""

from gspn_tpu_torch.parallel.dp import make_dp_inference, make_dp_train_step
from gspn_tpu_torch.parallel.mesh import (
    DataMesh,
    PointMesh,
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_batch,
)
from gspn_tpu_torch.parallel.points import make_sharded_backbone, sharded_backbone_body
from gspn_tpu_torch.parallel.scene import make_point_sharded_inference
from gspn_tpu_torch.parallel.spatial import make_spatial_inference
from gspn_tpu_torch.parallel.train_points import (
    make_point_sharded_gspn_loss_fn,
    make_point_sharded_gspn_train_step,
    make_point_sharded_rpointnet_loss_fn,
    make_point_sharded_rpointnet_train_step,
    make_point_sharded_train_step,
)

__all__ = [
    "DataMesh",
    "PointMesh",
    "make_dp_inference",
    "make_dp_train_step",
    "make_mesh",
    "make_mesh_2d",
    "make_point_sharded_gspn_loss_fn",
    "make_point_sharded_gspn_train_step",
    "make_point_sharded_inference",
    "make_point_sharded_rpointnet_loss_fn",
    "make_point_sharded_rpointnet_train_step",
    "make_point_sharded_train_step",
    "make_sharded_backbone",
    "make_spatial_inference",
    "replicate",
    "shard_batch",
    "sharded_backbone_body",
]
