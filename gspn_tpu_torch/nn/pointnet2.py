"""PointNet++ set abstraction (single- and multi-scale grouping, group-all)
and feature propagation: the PyTorch counterpart of
``gspn_tpu/nn/pointnet2.py``.

``dtype`` is the MLPs' compute dtype (``nn.layers``); the grouping and the
FP interpolation stay float32, as the JAX package keeps its point ops.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from gspn_tpu_torch import ops
from gspn_tpu_torch.nn.layers import PointMLP, masked_max, masked_mean

POOLINGS = ("max", "avg", "weighted_avg", "max_and_avg")


def sample_and_group(
    npoint: int,
    radius: float,
    nsample: int,
    xyz,
    points=None,
    valid=None,
    impl: str = "auto",
    fps_idx=None,
    fps_segments: int = 1,
    fps_segment_mode: str = "contiguous",
    select: str = "first",
    *,
    use_knn: bool = False,
    use_xyz: bool = True,
):
    """FPS -> gather -> fused ball group (local coordinates), or the
    ``nsample`` nearest neighbours with ``use_knn`` [-> feature gather].
    ``fps_idx (B, npoint)``: precomputed FPS indices to reuse. The grouped
    features follow the local coordinates, or stand alone with
    ``use_xyz=False``.

    Returns ``(new_xyz (B,P,3), new_points (B,P,K,3+C) or (B,P,K,C), idx
    (B,P,K), grouped_xyz (B,P,K,3), pts_cnt (B,P))``; ``pts_cnt`` is
    ``nsample`` everywhere with ``use_knn``."""
    if fps_idx is None:
        fps_idx = ops.farthest_point_sample(
            npoint, xyz, valid, impl=impl,
            segments=ops.eligible_fps_segments(fps_segments, npoint, xyz.shape[1]),
            segment_mode=fps_segment_mode,
        )
    new_xyz = ops.gather_point(xyz, fps_idx, impl=impl)
    if use_knn:
        _, idx = ops.knn_point(nsample, xyz, new_xyz, valid)
        pts_cnt = torch.full(idx.shape[:2], nsample, dtype=torch.int32, device=idx.device)
        grouped_xyz = ops.group_point(xyz, idx, impl=impl) - new_xyz[:, :, None, :]
    else:
        ((idx, pts_cnt, grouped_xyz),) = ops.query_ball_group_multi(
            (radius,), (nsample,), xyz, new_xyz, valid, impl=impl, select=select
        )
    if points is not None:
        grouped = ops.group_point(points, idx, impl=impl)
        new_points = torch.cat([grouped_xyz, grouped], dim=-1) if use_xyz else grouped
    else:
        new_points = grouped_xyz
    return new_xyz, new_points, idx, grouped_xyz, pts_cnt


def sample_and_group_all(xyz, points=None, use_xyz: bool = True):
    """One group of every point (the global pooling stage), centred at the
    origin as in the reference: ``(new_xyz (B,1,3) zeros, new_points
    (B,1,N,3+C) or (B,1,N,C), None, grouped_xyz (B,1,N,3))``."""
    new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
    grouped_xyz = xyz[:, None]
    if points is not None:
        grouped = points[:, None]
        new_points = torch.cat([grouped_xyz, grouped], dim=-1) if use_xyz else grouped
    else:
        new_points = grouped_xyz
    return new_xyz, new_points, None, grouped_xyz


class PointNetSAModule(nn.Module):
    """Set abstraction: single-scale grouping, or one group of every point
    (``group_all``), a shared MLP, a pooling over each group, and an
    optional MLP after it (``mlp2``). Returns ``(new_xyz, pooled
    (B,P,C_out), new_valid)``; groups whose centre found no valid point are
    zeroed. ``in_dim`` is the MLP's input width: 3 + C with ``use_xyz``,
    else C.

    ``pooling``: "max" (every published config), "avg", "weighted_avg"
    (a softmax over each group of minus the points' distances to the
    centre) or "max_and_avg" (both, concatenated). Group-all pools over the
    valid points only for "max" and "avg", as the JAX package does.
    ``use_knn`` groups the ``nsample`` nearest neighbours in place of the
    ball."""

    def __init__(
        self,
        in_dim: int,
        npoint: int,
        radius: float,
        nsample: int,
        mlp: Sequence[int],
        use_bn: bool = True,
        ops_impl: str = "auto",
        fps_segments: int = 1,
        fps_segment_mode: str = "contiguous",
        select: str = "first",
        dtype: torch.dtype = torch.float32,
        mlp2: Sequence[int] = (),
        group_all: bool = False,
        pooling: str = "max",
        use_knn: bool = False,
        use_xyz: bool = True,
    ):
        super().__init__()
        if pooling not in POOLINGS:
            raise ValueError(f"unknown pooling {pooling}")
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.ops_impl = ops_impl
        self.fps_segments, self.fps_segment_mode = fps_segments, fps_segment_mode
        self.select = select
        self.group_all, self.pooling = group_all, pooling
        self.use_knn, self.use_xyz = use_knn, use_xyz
        self.mlp = PointMLP(in_dim, mlp, use_bn=use_bn, dtype=dtype, ops_impl=ops_impl)
        pooled = mlp[-1] * (2 if pooling == "max_and_avg" else 1)
        self.mlp2 = (PointMLP(pooled, mlp2, use_bn=use_bn, dtype=dtype, ops_impl=ops_impl)
                     if mlp2 else None)

    def forward(self, xyz, points=None, valid=None, fps_idx=None):
        if self.group_all:
            new_xyz, new_points, _, grouped_xyz = sample_and_group_all(xyz, points,
                                                                       self.use_xyz)
            group_mask = valid[:, None, :] if valid is not None else None  # (B, 1, N)
            new_valid = None
        else:
            new_xyz, new_points, _, grouped_xyz, pts_cnt = sample_and_group(
                self.npoint, self.radius, self.nsample, xyz, points, valid,
                self.ops_impl, fps_idx, self.fps_segments, self.fps_segment_mode,
                self.select, use_knn=self.use_knn, use_xyz=self.use_xyz,
            )
            # groups are self-padded by replicate-first, so no group mask is
            # needed to pool; empty groups are zeroed through new_valid
            group_mask = None
            new_valid = pts_cnt > 0 if valid is not None else None
        feats = self.mlp(new_points, group_mask)
        pooled = self._pool(feats, grouped_xyz, group_mask)
        if self.mlp2 is not None:
            pooled = self.mlp2(pooled, new_valid)
        if new_valid is not None:
            pooled = torch.where(new_valid[..., None], pooled, torch.zeros_like(pooled))
        return new_xyz, pooled, new_valid

    def _pool(self, feats, grouped_xyz, group_mask):
        """Pool ``feats (B,P,K,C)`` over each group (dim 2)."""
        if self.pooling == "max":
            return feats.amax(dim=2) if group_mask is None else masked_max(feats, group_mask, 2)
        if self.pooling == "avg":
            return feats.mean(dim=2) if group_mask is None else masked_mean(feats, group_mask, 2)
        if self.pooling == "weighted_avg":
            g = grouped_xyz.to(feats.dtype)
            w = torch.softmax(-torch.sqrt((g * g).sum(dim=-1, keepdim=True)), dim=2)
            return (feats * w).sum(dim=2)
        return torch.cat([feats.amax(dim=2), feats.mean(dim=2)], dim=-1)  # max_and_avg


class PointNetSAModuleMSG(nn.Module):
    """Multi-scale grouping set abstraction: one FPS pass, the ball groups
    of every radius from one ``query_ball_group_multi`` call (one kernel
    launch on the card), a shared MLP (``mlp_s{s}``) and a max over each
    scale's groups, the scales' features concatenated. ``in_dim`` is each
    scale's MLP input width: 3 + C with ``use_xyz``, else C. Returns
    ``(new_xyz, (B,P,sum of the mlps' last widths), new_valid)``; a centre
    no scale found a valid point for is zeroed."""

    def __init__(
        self,
        in_dim: int,
        npoint: int,
        radius_list: Sequence[float],
        nsample_list: Sequence[int],
        mlp_list: Sequence[Sequence[int]],
        use_xyz: bool = True,
        use_bn: bool = True,
        ops_impl: str = "auto",
        fps_segments: int = 1,
        fps_segment_mode: str = "contiguous",
        select: str = "first",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if not len(radius_list) == len(nsample_list) == len(mlp_list):
            raise ValueError("radius_list, nsample_list and mlp_list need one entry a scale")
        self.npoint = npoint
        self.radius_list, self.nsample_list = tuple(radius_list), tuple(nsample_list)
        self.use_xyz, self.ops_impl = use_xyz, ops_impl
        self.fps_segments, self.fps_segment_mode = fps_segments, fps_segment_mode
        self.select = select
        for s, mlp in enumerate(mlp_list):
            self.add_module(f"mlp_s{s}", PointMLP(in_dim, mlp, use_bn=use_bn, dtype=dtype,
                                                  ops_impl=ops_impl))

    def forward(self, xyz, points=None, valid=None):
        fps_idx = ops.farthest_point_sample(
            self.npoint, xyz, valid, impl=self.ops_impl,
            segments=ops.eligible_fps_segments(self.fps_segments, self.npoint, xyz.shape[1]),
            segment_mode=self.fps_segment_mode,
        )
        new_xyz = ops.gather_point(xyz, fps_idx, impl=self.ops_impl)
        per_scale = ops.query_ball_group_multi(
            self.radius_list, self.nsample_list, xyz, new_xyz, valid, impl=self.ops_impl,
            select=self.select,
        )
        outs, any_cnt = [], None
        for s, (idx, cnt, grouped_xyz) in enumerate(per_scale):
            any_cnt = cnt if any_cnt is None else torch.maximum(any_cnt, cnt)
            if points is not None:
                grouped = ops.group_point(points, idx, impl=self.ops_impl)
                feats = torch.cat([grouped_xyz, grouped], dim=-1) if self.use_xyz else grouped
            else:
                feats = grouped_xyz
            outs.append(getattr(self, f"mlp_s{s}")(feats).amax(dim=2))
        out = torch.cat(outs, dim=-1)
        new_valid = any_cnt > 0 if valid is not None else None
        if new_valid is not None:
            out = torch.where(new_valid[..., None], out, torch.zeros_like(out))
        return new_xyz, out, new_valid


class PointNetFPModule(nn.Module):
    """Feature propagation: three_nn -> inverse-distance weights ->
    interpolation -> skip concat -> shared MLP.

    ``interp`` picks the interpolation, as in the JAX package:

    - "exact": the neighbor-ordered gather and weighted sum;
    - "mm": ``ops.three_interpolate_fp``, the TPU's matmul kernel's
      counterpart with the weights and the skip concat folded in, which
      launches the ``interp_mm`` kernel once on the card and gives the
      same bits as "exact";
    - "auto": "mm" when ``ops_impl`` resolves to the CUDA kernels for the
      input, "exact" otherwise (as the JAX package's "auto" takes "mm" only
      on the Pallas path).

    Either way the sources and the skip features are cast to float32 first
    (exact: bfloat16 values are float32 values), the interpolation and the
    concat are float32, and the MLP casts them to its ``dtype``, as the JAX
    package's float32 interpolation promotes the concat."""

    def __init__(
        self, in_dim: int, mlp: Sequence[int], use_bn: bool = True, ops_impl: str = "auto",
        interp: str = "auto", dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if interp not in ("auto", "exact", "mm"):
            raise ValueError(f"interp must be auto|exact|mm, got {interp!r}")
        self.ops_impl = ops_impl
        self.interp = interp
        self.mlp = PointMLP(in_dim, mlp, use_bn=use_bn, dtype=dtype, ops_impl=ops_impl)

    def forward(self, xyz1, xyz2, points1, points2, valid1=None, valid2=None):
        """``xyz1 (B,N,3)`` targets with skip features ``points1 (B,N,C1)``
        or None; ``xyz2 (B,M,3)`` sources with ``points2 (B,M,C2)`` ->
        ``(B,N,mlp[-1])``."""
        dist, idx = ops.three_nn(xyz1, xyz2, valid2, impl=self.ops_impl)
        points2 = points2.float()
        points1 = None if points1 is None else points1.float()
        use_mm = self.interp == "mm" or (
            self.interp == "auto" and ops.resolve_impl(self.ops_impl, xyz1) == "cuda"
        )
        if use_mm:
            feats = ops.three_interpolate_fp(points2, idx, dist, points1, impl=self.ops_impl)
        else:
            interp = ops.three_interpolate(points2, idx, ops.three_interpolate_weights(dist),
                                           impl=self.ops_impl)
            feats = interp if points1 is None else torch.cat([interp, points1], dim=-1)
        out = self.mlp(feats, valid1)
        if valid1 is not None:
            out = torch.where(valid1[..., None], out, torch.zeros_like(out))
        return out
