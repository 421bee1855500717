"""Point-level sharding of the PointNet++ backbone over the ranks of a
:class:`~gspn_tpu_torch.parallel.mesh.PointMesh` row: the PyTorch
counterpart of ``gspn_tpu/parallel/points.py``.

The coordinates are replicated (N x 3 floats); the per-point work and
feature maps shard:

- FPS is sequential and global: it runs replicated, the same on every rank;
- sa1 (the N-sized neighbourhood scan): each rank groups, encodes and pools
  its slice of the FPS centres; the pooled level (P1 x C) is all-gathered;
- sa2.. work on at most P1 centres: replicated;
- an FP level whose target count divides by the ranks, with at least 8
  targets a rank, shards its targets (the sources stay whole); its output
  is all-gathered where it feeds the next FP level, and the final
  per-point map stays sharded on the point axis.

In training every BatchNorm of the backbone must take its statistics over
the reduction group (``nn.layers.cross_rank_statistics``), the replicated
levels too, as the JAX package's ``bn_axis``. Indices and counts equal the
single-process backbone's; features agree to float tolerance (a rank's
slice changes the MLPs' batch shapes, and with them the order of sums).
"""

from __future__ import annotations

from gspn_tpu_torch import ops
from gspn_tpu_torch.models.rpointnet import Backbone
from gspn_tpu_torch.nn.layers import MaskedBatchNorm, all_gather_tiled
from gspn_tpu_torch.parallel.mesh import PointMesh


def check_divisible(name: str, value: int, nshards: int) -> None:
    if value % nshards:
        raise ValueError(f"{name}={value} not divisible by {nshards} shards")


def check_seed_count(cfg, mesh: PointMesh) -> None:
    """The sharded pipelines' refusal of a seed count that does not split
    over the row's ranks."""
    if cfg.num_seeds % mesh.n_space:
        raise ValueError(f"num_seeds={cfg.num_seeds} not divisible by mesh axis {mesh.n_space}")


def shard_slice(a, index: int, nshards: int, dim: int = 1):
    """Part ``index`` of ``nshards`` equal parts of ``a`` along ``dim``, a
    contiguous tensor as the kernels take it (None stays None)."""
    if a is None:
        return None
    per = a.shape[dim] // nshards
    return a.narrow(dim, index * per, per).contiguous()


def sharded_backbone_body(backbone: Backbone, mesh: PointMesh, xyz, valid, sa1_fps_idx=None,
                          features=None):
    """This rank's slice of the ``(B, N, C)`` feature map of ``backbone``
    with its per-point work sharded over ``mesh.space`` (every rank of the
    row calls it on the same scenes). ``sa1_fps_idx``: the replicated
    ``(B, P1)`` FPS centres of sa1 (the pipeline's shared pass), else
    sampled here. In training mode the statistics of the updated running
    means are those of the whole reduction set, the same on every rank."""
    cfg = backbone.config
    nshards, i = mesh.n_space, mesh.space_index
    if backbone.training and cfg.use_bn and any(
            m.group is None for m in backbone.modules() if isinstance(m, MaskedBatchNorm)):
        raise ValueError("sharded training with BN needs cross-shard statistics: run the "
                         "backbone under nn.layers.cross_rank_statistics(model, group)")
    p1 = cfg.sa_layers[0].npoint
    n = xyz.shape[1]
    check_divisible("sa1 npoint", p1, nshards)
    check_divisible("N", n, nshards)
    if cfg.feature_dim > 0 and features is None:
        raise ValueError(f"the config has feature_dim={cfg.feature_dim}: pass features")

    def gather(a):
        return None if a is None else all_gather_tiled(a, 1, mesh.space)

    fps_idx = sa1_fps_idx
    if fps_idx is None:
        fps_idx = ops.farthest_point_sample(
            p1, xyz, valid, impl=cfg.ops_impl,
            segments=ops.eligible_fps_segments(cfg.fps_segments, p1, n),
            segment_mode=cfg.fps_segment_mode,
        )
    # sa1: replicated FPS, this rank's centres; the pooled level gathered
    feats = features if cfg.feature_dim > 0 else None
    nx, nf, nv = backbone.sa1(xyz, feats, valid, shard_slice(fps_idx, i, nshards))
    xs, fs, vs = [xyz, gather(nx)], [feats, gather(nf)], [valid, gather(nv)]
    nsa = len(cfg.sa_layers)
    for li in range(1, nsa):  # small centroid sets: replicated
        nx, nf, nv = getattr(backbone, f"sa{li + 1}")(xs[-1], fs[-1], vs[-1])
        xs.append(nx)
        fs.append(nf)
        vs.append(nv)

    feat = fs[-1]
    for fi in range(len(cfg.fp_mlps)):
        lvl = nsa - 1 - fi  # the target level
        fp = getattr(backbone, f"fp{fi + 1}")
        tgt_n = xs[lvl].shape[1]
        if tgt_n % nshards == 0 and tgt_n // nshards >= 8:
            def sl(a):
                return shard_slice(a, i, nshards)

            feat = fp(sl(xs[lvl]), xs[lvl + 1], sl(fs[lvl]), feat, sl(vs[lvl]), vs[lvl + 1])
            if fi < len(cfg.fp_mlps) - 1:  # the next level's sources
                feat = gather(feat)
        else:
            feat = fp(xs[lvl], xs[lvl + 1], fs[lvl], feat, vs[lvl], vs[lvl + 1])
            if fi == len(cfg.fp_mlps) - 1:  # the final map leaves sharded
                feat = shard_slice(feat, i, nshards)
    return feat


def make_sharded_backbone(cfg, mesh: PointMesh):
    """``fn(backbone, xyz, valid, features=None) -> (B, N, C)``: the feature
    map of a ``Backbone`` built from ``cfg`` with its per-point work sharded
    over ``mesh.space`` and the ranks' slices gathered back, so every rank
    returns the whole map. ``cfg.sa_layers[0].npoint`` and N must divide by
    the row's ranks."""
    check_divisible("sa1 npoint", cfg.sa_layers[0].npoint, mesh.n_space)

    def fn(backbone: Backbone, xyz, valid, features=None):
        if backbone.config != cfg:
            raise ValueError("the backbone was built from another config than this function's")
        feat = sharded_backbone_body(backbone, mesh, xyz, valid, features=features)
        return all_gather_tiled(feat, 1, mesh.space)

    return fn


def reassemble(preds, mesh: PointMesh):
    """Every rank's slice of each field of ``preds`` (a rank's proposals of
    its scenes) gathered back into the whole batch's, on every rank: along
    the proposal axis over the row, then along the scene axis over the
    column (JAX's ``out_specs``)."""
    return type(preds)(**{
        name: all_gather_tiled(all_gather_tiled(t, 1, mesh.space), 0, mesh.data)
        for name, t in vars(preds).items()
    })


def scene_rows(mesh: PointMesh, *tensors):
    """This rank's data row's scenes of each full-batch tensor (the leading
    dim split into ``mesh.n_data`` equal parts; None stays None)."""
    out = []
    for t in tensors:
        if t is not None:
            check_divisible("batch", t.shape[0], mesh.n_data)
        out.append(shard_slice(t, mesh.data_index, mesh.n_data, dim=0))
    return out
