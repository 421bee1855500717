"""The plain reference's training: the stage-1 (GSPN) and stage-2
(R-PointNet over a frozen GSPN's proposals) losses, their gradients by
autograd, and Adam, over a state dict.

A step's draws come from a ``torch.Generator`` the caller seeds: stage 1
the CVAE noise; stage 2 the GT boxes' jitter, then the frozen GSPN's CVAE
noise. The benchmark seeds the program's step generator the same way, so
both sides see the same draws.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_h100 import workcount as wc
from bench_h100.reference import model as M
from bench_h100.reference import ops

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def huber(x, delta: float = 1.0):
    a = torch.abs(x)
    return torch.where(a <= delta, 0.5 * x * x, delta * (a - 0.5 * delta))


def seed_instances(xyz, inst_label, seed_idx, gt_size: int):
    """Each seed's instance: its first ``gt_size`` points in index order
    (``gt_points``, ``gt_valid``), the instance's mean and whether the seed
    lies on one."""
    n = xyz.shape[1]
    seed_inst = torch.gather(inst_label, 1, seed_idx)
    is_fg = seed_inst > 0
    member = (inst_label[:, None, :] == seed_inst[:, :, None]) & is_fg[:, :, None]
    iota = torch.arange(n, device=xyz.device)
    pos = torch.where(member, iota, torch.full_like(iota, n))
    first = torch.topk(pos, gt_size, dim=-1, largest=False, sorted=True).values
    idx = torch.where(first >= n, torch.zeros_like(first), first)
    cnt = member.sum(-1)
    gt_valid = torch.arange(gt_size, device=xyz.device) < torch.clamp(cnt, max=gt_size)[..., None]
    gt_points = ops.gather_rows(xyz, idx) * gt_valid[..., None].to(xyz.dtype)
    w = member.to(xyz.dtype)
    gt_center = torch.bmm(w, xyz) / torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    return gt_points, gt_valid, gt_center, is_fg


def gspn_loss(cfg: dict, state: dict, batch: dict, generator: torch.Generator):
    """Stage 1: FPS seeds, their GT instances, the CVAE forward through the
    recognition network, and the chamfer, KL, centre and objectness terms."""
    g, t = cfg["gspn"], cfg["train"]
    xyz, valid = batch["xyz"], batch["valid"]
    s = t["num_seeds"]
    seed_idx = ops.fps(s, xyz, valid, ops.eligible_segments(g["fps_segments"], s, xyz.shape[1]),
                       g["fps_segment_mode"])
    gt_points, gt_valid, gt_center, is_fg = seed_instances(xyz, batch["inst_label"], seed_idx,
                                                           t["gt_size"])
    z_eps = torch.randn((xyz.shape[0], s, g["latent_dim"]), generator=generator,
                        device=generator.device).to(xyz.device)
    out = M.gspn(M.Params(state, training=True), "", g, xyz, seed_idx, valid, z_eps,
                 gt_points, gt_valid)
    b, s_, gn, _ = out["generated"].shape
    pred = out["generated"].reshape(b * s_, gn, 3)
    tgt = gt_points.reshape(b * s_, -1, 3)
    tv = gt_valid.reshape(b * s_, -1)
    idx1, idx2 = ops.nn_pair(pred.detach(), tgt, tv)
    d1 = pred - ops.gather_rows(tgt, idx1)
    d2 = tgt - ops.gather_rows(pred, idx2)
    dist1 = d1[..., 0] * d1[..., 0] + d1[..., 1] * d1[..., 1] + d1[..., 2] * d1[..., 2]
    dist2 = d2[..., 0] * d2[..., 0] + d2[..., 1] * d2[..., 1] + d2[..., 2] * d2[..., 2]
    w = tv.to(dist2.dtype)
    ch = (dist1.mean(-1) + (dist2 * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0)).reshape(b, s_)
    var_q, var_p = torch.exp(out["q_logvar"]), torch.exp(out["prior_logvar"])
    kl = (0.5 * (out["prior_logvar"] - out["q_logvar"]
                 + (var_q + (out["q_mu"] - out["prior_mu"]) ** 2) / var_p - 1.0)).sum(-1)
    cerr = huber(out["center"] - gt_center).sum(-1)
    y = is_fg.to(torch.float32)
    obj = -y * F.logsigmoid(out["objectness"]) - (1.0 - y) * F.logsigmoid(-out["objectness"])
    npos = torch.clamp(y.sum(), min=1.0)
    nval = torch.clamp(torch.ones_like(y).sum(), min=1.0)
    return ((ch * y).sum() / npos + (kl * y).sum() / npos + (cerr * y).sum() / npos
            + obj.sum() / nval)


def instance_boxes(xyz, inst_label, sem_label, max_instances: int):
    """Each instance's box, class (its largest semantic label) and presence."""
    ids = torch.arange(1, max_instances + 1, device=xyz.device)
    member = inst_label[:, None, :] == ids[None, :, None]
    present = member.any(-1)
    px, m = xyz[:, None, :, :], member[..., None]
    lo = torch.where(m, px, torch.full_like(px, 1e9)).amin(2)
    hi = torch.where(m, px, torch.full_like(px, -1e9)).amax(2)
    boxes = torch.where(present[..., None], torch.cat([lo, hi], -1), torch.zeros_like(lo[..., :1]))
    sem = torch.where(member, sem_label[:, None, :], torch.zeros_like(sem_label[:, None, :]))
    return boxes, sem.amax(-1), present


def rpointnet_loss(cfg: dict, state: dict, frozen: dict, batch: dict,
                   generator: torch.Generator):
    """Stage 2: jittered GT boxes and the frozen GSPN's proposals at FPS
    seeds (one pass that SA1 shares) as RoIs, the training forward, IoU
    matching and the classification, box and mask terms."""
    g, r, t = cfg["gspn"], cfg["rpointnet"], cfg["train"]
    xyz, valid = batch["xyz"], batch["valid"]
    gt_boxes, gt_cls, present = instance_boxes(xyz, batch["inst_label"], batch["sem_label"],
                                               t["max_instances"])
    box_noise = torch.randn(gt_boxes.shape, generator=generator,
                            device=generator.device).to(xyz.device)
    gt_rois = torch.where(present[..., None], gt_boxes + box_noise * t["gt_box_jitter"],
                          torch.zeros_like(gt_boxes))
    s, sa1 = t["num_seeds"], r["sa_layers"][0][0]
    n = xyz.shape[1]
    segs = r["fps_segments"]
    if any(ops.eligible_segments(segs, k, n) != segs for k in (s, sa1)):
        segs = 1
    fps_all = ops.fps(max(s, sa1), xyz, valid, segs, r["fps_segment_mode"])
    z_eps = torch.randn((xyz.shape[0], s, g["latent_dim"]), generator=generator,
                        device=generator.device).to(xyz.device)
    with torch.no_grad(), wc.frozen_products():
        gout = M.gspn(M.Params(frozen), "", g, xyz, fps_all[:, :s], valid, z_eps)
        rois = torch.cat([M.proposal_boxes(gout["generated"], r["box_margin"]), gt_rois], 1)
    p = M.Params(state, training=True)
    feat = M.backbone(p, "", r, xyz, valid, fps_all[:, :sa1])
    out = M.roi_heads(p, "", r, xyz, feat, rois, valid)
    iou = ops.box_iou(rois, gt_boxes)
    iou = torch.where(present[:, None, :], iou, torch.full_like(iou, -1.0))
    best, matched = iou.amax(-1), iou.argmax(-1)
    is_fg = (best >= r["fg_iou"]) & out["roi_valid"]
    is_bg = (best < r["bg_iou"]) & out["roi_valid"]
    cls_t = torch.where(is_fg, torch.gather(gt_cls, 1, matched), torch.zeros_like(matched))
    mb = torch.gather(gt_boxes, 1, matched[..., None].expand(-1, -1, 6))
    sc = (rois[..., 0:3] + rois[..., 3:6]) * 0.5
    se = torch.clamp(rois[..., 3:6] - rois[..., 0:3], min=1e-6)
    dc = (mb[..., 0:3] + mb[..., 3:6]) * 0.5
    de = torch.clamp(mb[..., 3:6] - mb[..., 0:3], min=1e-6)
    box_t = torch.cat([(dc - sc) / se, torch.log(de / se)], -1)
    train = (is_fg | is_bg).to(torch.float32)
    fg = is_fg.to(torch.float32)
    ce = -torch.gather(torch.log_softmax(out["cls_logits"], -1), -1, cls_t[..., None])[..., 0]
    box_err = huber(out["box_deltas"] - box_t).sum(-1)
    pt_inst = torch.gather(batch["inst_label"], 1,
                           out["roi_idx"].reshape(xyz.shape[0], -1)).reshape(out["roi_idx"].shape)
    target = (pt_inst == (matched[..., None] + 1)).to(torch.float32)
    lg = out["mask_logits"]
    bce = torch.clamp(lg, min=0.0) - lg * target + torch.log1p(torch.exp(-torch.abs(lg)))
    nfg = torch.clamp(fg.sum(), min=1.0)
    return ((ce * train).sum() / torch.clamp(train.sum(), min=1.0) + (box_err * fg).sum() / nfg
            + (bce.mean(-1) * fg).sum() / nfg)


def adam_step(params: dict, grads: dict, moments: dict, step: int, lr: float) -> None:
    """One Adam update in place (PyTorch's and optax's formula: the bias
    corrections on the step size and on the second moment's root)."""
    bc1, bc2 = 1.0 - ADAM_B1 ** step, 1.0 - ADAM_B2 ** step
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            m, v = moments.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
            m = ADAM_B1 * m + (1 - ADAM_B1) * g
            v = ADAM_B2 * v + (1 - ADAM_B2) * g * g
            moments[k] = (m, v)
            params[k] = p - (lr / bc1) * m / (torch.sqrt(v) / bc2 ** 0.5 + ADAM_EPS)


def train_steps(cfg: dict, state: dict, batches: list, generators: list, frozen: dict | None,
                trainable: set, moments: dict | None = None, done: int = 0) -> list[dict]:
    """Steps of the configuration's loss from ``state`` (not changed), one a
    batch, each step's draws from its generator; Adam starts from
    ``moments`` (``{leaf: (m, v)}``, none: zero) after ``done`` steps.
    Returns per step ``dict(loss, grads, state)``: the loss, the gradient
    of every trainable leaf, and the state after the update (parameters
    and BatchNorm running statistics)."""
    state = {k: v.detach().clone() for k, v in state.items()}
    moments = {k: (m.clone(), v.clone()) for k, (m, v) in (moments or {}).items()}
    out = []
    for i, (batch, gen) in enumerate(zip(batches, generators), start=done + 1):
        leaves = {k: state[k].requires_grad_(True) for k in trainable}
        if cfg["kind"] == "gspn_train":
            loss = gspn_loss(cfg, state, batch, gen)
        else:
            loss = rpointnet_loss(cfg, state, frozen, batch, gen)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        params = {k: v.detach() for k, v in leaves.items()}
        adam_step(params, grads, moments, i, cfg["train"]["lr"])
        state = {k: (params[k] if k in params else v.detach()) for k, v in state.items()}
        out.append(dict(loss=loss.detach(), grads=grads, state=dict(state)))
    return out
