"""Seed -> GT-instance pairing on the device: the PyTorch counterpart of
``gspn_tpu/data/instances.py``. Every output is fixed-shape and masked, so
the pairing runs inside the training step with no host round trip."""

from __future__ import annotations

import torch

from gspn_tpu_torch.ops.grouping import gather_point


def gather_seed_instances(xyz, inst_label, seed_idx, gt_size: int):
    """For each seed, the first ``gt_size`` scene points (in index order) of
    the seed's instance. ``xyz (B,N,3)``, ``inst_label (B,N)`` int (0 =
    background), ``seed_idx (B,S)`` int.

    Returns ``gt_points (B,S,G,3)`` (zeros where invalid), ``gt_valid
    (B,S,G)`` bool, ``gt_center (B,S,3)`` (the mean of the whole instance,
    not only its first G points, as a float32 matrix product: keep TF32 off
    on the card) and ``seed_is_fg (B,S)`` bool (the seed lies on an
    instance)."""
    n = xyz.shape[1]
    seed_inst = torch.gather(inst_label, 1, seed_idx.long())  # (B, S)
    is_fg = seed_inst > 0
    member = (inst_label[:, None, :] == seed_inst[:, :, None]) & is_fg[:, :, None]  # (B, S, N)

    iota = torch.arange(n, dtype=torch.int32, device=xyz.device)
    pos = torch.where(member, iota, torch.full_like(iota, n))
    first = torch.topk(pos, gt_size, dim=-1, largest=False, sorted=True).values  # G lowest
    idx = torch.where(first >= n, torch.zeros_like(first), first)  # (B, S, G)
    cnt = member.sum(dim=-1)  # (B, S) whole instance size
    gt_valid = (torch.arange(gt_size, device=xyz.device)
                < torch.clamp(cnt, max=gt_size)[..., None])

    b, s, g = idx.shape
    flat = gather_point(xyz, idx.reshape(b, s * g))
    gt_points = flat.reshape(b, s, g, 3) * gt_valid[..., None].to(xyz.dtype)

    w = member.to(xyz.dtype)
    tot = torch.clamp(w.sum(dim=-1, keepdim=True), min=1.0)
    gt_center = torch.bmm(w, xyz) / tot
    return gt_points, gt_valid, gt_center, is_fg
