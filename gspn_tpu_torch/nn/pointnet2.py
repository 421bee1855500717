"""PointNet++ set abstraction (SSG, max pool) and feature propagation: the
PyTorch counterpart of ``gspn_tpu/nn/pointnet2.py``'s inference path.

``dtype`` is the MLPs' compute dtype (``nn.layers``); the grouping and the
FP interpolation stay float32, as the JAX package keeps its point ops.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from gspn_tpu_torch import ops
from gspn_tpu_torch.nn.layers import PointMLP


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
):
    """FPS -> gather -> fused ball group (local coordinates) [-> feature
    gather]. ``fps_idx (B, npoint)``: precomputed FPS indices to reuse.

    Returns ``(new_xyz (B,P,3), new_points (B,P,K,3+C), idx (B,P,K),
    grouped_xyz (B,P,K,3), pts_cnt (B,P))``."""
    if fps_idx is None:
        fps_idx = ops.farthest_point_sample(
            npoint, xyz, valid, impl=impl,
            segments=ops.eligible_fps_segments(fps_segments, npoint, xyz.shape[1]),
            segment_mode=fps_segment_mode,
        )
    new_xyz = ops.gather_point(xyz, fps_idx, impl=impl)
    ((idx, pts_cnt, grouped_xyz),) = ops.query_ball_group_multi(
        (radius,), (nsample,), xyz, new_xyz, valid, impl=impl, select=select
    )
    if points is not None:
        new_points = torch.cat([grouped_xyz, ops.group_point(points, idx, impl=impl)], dim=-1)
    else:
        new_points = grouped_xyz
    return new_xyz, new_points, idx, grouped_xyz, pts_cnt


class PointNetSAModule(nn.Module):
    """Set abstraction, single-scale grouping with max pooling (what every
    published config uses). Returns ``(new_xyz, pooled (B,P,C_out),
    new_valid)``; groups whose centre found no valid point are zeroed."""

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
    ):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.ops_impl = ops_impl
        self.fps_segments, self.fps_segment_mode = fps_segments, fps_segment_mode
        self.select = select
        self.mlp = PointMLP(in_dim, mlp, use_bn=use_bn, dtype=dtype)

    def forward(self, xyz, points=None, valid=None, fps_idx=None):
        new_xyz, new_points, _, _, pts_cnt = sample_and_group(
            self.npoint, self.radius, self.nsample, xyz, points, valid,
            self.ops_impl, fps_idx, self.fps_segments, self.fps_segment_mode,
            self.select,
        )
        # groups are self-padded by replicate-first, so no group mask is
        # needed for max; empty groups are zeroed through new_valid
        new_valid = pts_cnt > 0 if valid is not None else None
        pooled = self.mlp(new_points).amax(dim=2)
        if new_valid is not None:
            pooled = torch.where(new_valid[..., None], pooled, torch.zeros_like(pooled))
        return new_xyz, pooled, new_valid


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
        self.mlp = PointMLP(in_dim, mlp, use_bn=use_bn, dtype=dtype)

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
