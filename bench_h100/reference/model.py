"""The plain reference model: GSPN proposals, NMS, R-PointNet (PointNet++
backbone, point RoIAlign, heads) and the 1-NN mask projection, as
functions of a state dict.

It follows the published GSPN (Yi et al., CVPR 2019) and R-PointNet as
SURVEY.md reconstructs them from ``ericyi/GSPN`` and
``charlesq34/pointnet2``, at the widths a configuration file states, with
the conventions the program serves: channel-last BatchNorm with epsilon
1e-3 and momentum 0.9 on the running statistics, glorot-uniform Dense
weights, the first K points of a ball or box in index order. It imports
torch and this directory only; parameters are read by the names
:func:`param_spec` lists, which are the keys of the state dict the
benchmark makes.
"""

from __future__ import annotations

import torch

from bench_h100 import workcount as wc
from bench_h100.reference import ops

BN_EPS = 1e-3
BN_MOMENTUM = 0.9


# ---------------------------------------------------------------- parameters


def _mlp_spec(prefix, cin, widths):
    out, c = [], cin
    for i, w in enumerate(widths):
        out += [(f"{prefix}.dense_{i}.weight", (w, c), "dense_w"),
                (f"{prefix}.dense_{i}.bias", (w,), "zero")]
        out += [(f"{prefix}.bn_{i}.{k}", (w,), kind)
                 for k, kind in (("scale", "one"), ("bias", "zero"), ("mean", "zero"),
                                 ("var", "one"))]
        c = w
    return out


def _fc_spec(prefix, cin, hidden, cout):
    out, c = [], cin
    for i, w in enumerate(hidden):
        out += [(f"{prefix}.fc_{i}.weight", (w, c), "dense_w"),
                (f"{prefix}.fc_{i}.bias", (w,), "zero")]
        c = w
    return out + [(f"{prefix}.fc_out.weight", (cout, c), "dense_w"),
                  (f"{prefix}.fc_out.bias", (cout,), "zero")]


def gspn_spec(g: dict, prefix: str = "gspn", recognition: bool = False):
    ns = len(g["context_radii"])
    crop = 3 + g["feature_dim"]
    out = _mlp_spec(f"{prefix}.center_enc.mlp", crop, g["center_mlp"])
    out += _fc_spec(f"{prefix}.center_fc", g["center_mlp"][-1], g["center_fc"], 3)
    for s in range(ns):
        out += _mlp_spec(f"{prefix}.ctx_enc_{s}.mlp", crop, g["encoder_mlp"])
    out += _fc_spec(f"{prefix}.cond_fc", ns * g["encoder_mlp"][-1], (), g["cond_dim"])
    out += _fc_spec(f"{prefix}.prior.FCLayers_0", g["cond_dim"], (g["cond_dim"],),
                    2 * g["latent_dim"])
    out += _fc_spec(f"{prefix}.generator", g["latent_dim"] + g["cond_dim"], g["generator_fc"],
                    g["num_gen_points"] * 3)
    out += _fc_spec(f"{prefix}.objectness", g["cond_dim"], g["objectness_fc"], 1)
    if recognition:
        out += _mlp_spec(f"{prefix}.recog_enc.mlp", 3, g["encoder_mlp"])
        out += _fc_spec(f"{prefix}.recognition.FCLayers_0", g["encoder_mlp"][-1] + g["cond_dim"],
                        (g["cond_dim"],), g["latent_dim"] * 2)
    return out


def rpointnet_spec(r: dict, prefix: str = "rpointnet"):
    chans, out = [r["feature_dim"]], []
    for i, (_, _, _, mlp) in enumerate(r["sa_layers"]):
        out += _mlp_spec(f"{prefix}.backbone.sa{i + 1}.mlp", 3 + chans[-1], mlp)
        chans.append(mlp[-1])
    feat = chans[-1]
    for i, mlp in enumerate(r["fp_mlps"]):
        lvl = len(r["sa_layers"]) - 1 - i
        out += _mlp_spec(f"{prefix}.backbone.fp{i + 1}.mlp", feat + chans[lvl], mlp)
        feat = mlp[-1]
    c = r["roi_mlp"][-1]
    out += _mlp_spec(f"{prefix}.heads.roi_mlp", 3 + feat, r["roi_mlp"])
    out += _fc_spec(f"{prefix}.heads.cls", c, r["cls_fc"], r["num_classes"] + 1)
    out += _fc_spec(f"{prefix}.heads.box", c, r["box_fc"], 6)
    out += _mlp_spec(f"{prefix}.heads.mask_mlp", 2 * c, r["mask_mlp"])
    out += [(f"{prefix}.heads.mask_out.weight", (1, r["mask_mlp"][-1]), "dense_w"),
            (f"{prefix}.heads.mask_out.bias", (1,), "zero")]
    return out


_PLAIN = {"feature_dim": 0, "group_select": "first", "dtype": "float32", "use_bn": True,
          "roi_sample": "inbox", "roi_randomize": False, "head_dropout": 0.0,
          "mask_project": "1nn", "mask_project_prune": "off", "box_percentile": 0.0,
          "sa1_fps_segments": 0}


def check_supported(cfg: dict) -> None:
    """Raise ``ValueError`` for a configuration outside what this reference
    computes (the fields of ``_PLAIN`` at other values)."""
    for part in (cfg, cfg.get("gspn", {}), cfg.get("rpointnet", {})):
        for key, want in _PLAIN.items():
            if key in part and part[key] != want:
                raise ValueError(f"the reference computes {key}={want!r}, got {part[key]!r}")


def param_spec(cfg: dict):
    """``[(key, shape, kind)]`` of the configuration's model: ``kind`` is
    "dense_w" (glorot-uniform), "zero" or "one". A pipeline holds
    ``gspn.*`` and ``rpointnet.*``; a stage-1 configuration its GSPN with
    the recognition network under no prefix; a stage-2 configuration its
    R-PointNet under no prefix (the frozen GSPN: :func:`frozen_spec`)."""
    check_supported(cfg)
    kind = cfg["kind"]
    if kind == "pipeline":
        return gspn_spec(cfg["gspn"]) + rpointnet_spec(cfg["rpointnet"])
    if kind == "gspn_train":
        return [(k[len("gspn."):], s, t) for k, s, t in gspn_spec(cfg["gspn"], recognition=True)]
    if kind == "rpointnet_train":
        return [(k[len("rpointnet."):], s, t) for k, s, t in rpointnet_spec(cfg["rpointnet"])]
    raise ValueError(f"unknown configuration kind {kind!r}")


def frozen_spec(cfg: dict):
    """A stage-2 configuration's frozen inference GSPN, no prefix."""
    return [(k[len("gspn."):], s, t) for k, s, t in gspn_spec(cfg["gspn"])]


def seeded_state(spec, generator: torch.Generator, device) -> dict:
    """Weights of ``spec`` from one uniform draw on ``device``: each Dense
    weight glorot-uniform in ``±sqrt(6 / (fan_in + fan_out))``, biases and
    BatchNorm shifts and means 0, scales and variances 1."""
    sizes = [int(torch.Size(s).numel()) if k == "dense_w" else 0 for _, s, k in spec]
    u = torch.rand(sum(sizes), generator=generator, device=device)
    out, at = {}, 0
    for (key, shape, kind), size in zip(spec, sizes):
        if kind == "dense_w":
            limit = (6.0 / (shape[0] + shape[1])) ** 0.5
            out[key] = (u[at:at + size].reshape(shape) * 2.0 - 1.0) * limit
            at += size
        else:
            out[key] = (torch.zeros if kind == "zero" else torch.ones)(shape, device=device)
    return out


# ---------------------------------------------------------------- layers


class Params:
    """A state dict read by prefix; in training its BatchNorms take the
    batch's statistics and move the running ones in ``state``."""

    def __init__(self, state: dict, training: bool = False):
        self.state, self.training = state, training

    def dense(self, name, x):
        w, b = self.state[f"{name}.weight"], self.state[f"{name}.bias"]
        wc.matmul(x.numel() // x.shape[-1], w.shape[1], w.shape[0])
        return x @ w.t() + b

    def bn(self, name, x, mask=None):
        s = self.state
        scale, bias = s[f"{name}.scale"], s[f"{name}.bias"]
        if not self.training:
            return (x - s[f"{name}.mean"]) * torch.rsqrt(s[f"{name}.var"] + BN_EPS) * scale + bias
        if mask is None:
            tot = torch.tensor(float(x.shape[0]), device=x.device)
            s1, s2 = x.sum(0), (x * x).sum(0)
        else:
            w = mask.to(x.dtype)[:, None]
            tot = w.sum()
            s1, s2 = (x * w).sum(0), (x * x * w).sum(0)
        tot = torch.clamp(tot, min=1.0)
        mean = s1 / tot
        var = torch.clamp(s2 / tot - mean * mean, min=0.0)
        with torch.no_grad():
            s[f"{name}.mean"] = BN_MOMENTUM * s[f"{name}.mean"] + (1 - BN_MOMENTUM) * mean
            s[f"{name}.var"] = BN_MOMENTUM * s[f"{name}.var"] + (1 - BN_MOMENTUM) * var
        return (x - mean) * torch.rsqrt(var + BN_EPS) * scale + bias

    def mlp(self, name, x, n, mask=None):
        """``n`` layers of Dense, BatchNorm, ReLU on the last axis; ``mask``
        (``x``'s leading shape) weights the training statistics."""
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        if mask is not None:
            mask = mask.expand(lead).reshape(-1)
        for i in range(n):
            x = torch.relu(self.bn(f"{name}.bn_{i}", self.dense(f"{name}.dense_{i}", x), mask))
        return x.reshape(*lead, x.shape[-1])

    def fc(self, name, x, n_hidden):
        for i in range(n_hidden):
            x = torch.relu(self.dense(f"{name}.fc_{i}", x))
        return self.dense(f"{name}.fc_out", x)


def masked_max(x, mask, dim):
    m = mask[..., None]
    out = torch.where(m, x, torch.full_like(x, -1e10)).amax(dim=dim)
    return torch.where(m.any(dim=dim), out, torch.zeros_like(out))


# ---------------------------------------------------------------- GSPN


def gspn(p: Params, pre: str, g: dict, xyz, seed_idx, valid, z_eps, gt_points=None,
         gt_valid=None):
    """Proposals at the seeds: ``dict(center, generated (B, S, G, 3),
    objectness (B, S), prior_mu, prior_logvar[, q_mu, q_logvar])``."""
    seed_xyz = ops.gather_rows(xyz, seed_idx)
    crops = [local for _, _, local in ops.ball_group(g["context_radii"], g["context_nsample"],
                                                     xyz, seed_xyz, valid)]
    nm = len(g["center_mlp"])
    offset = p.fc(f"{pre}center_fc", p.mlp(f"{pre}center_enc.mlp", crops[-1], nm).amax(-2),
                  len(g["center_fc"]))
    center = seed_xyz + offset
    ne = len(g["encoder_mlp"])
    encs = [p.mlp(f"{pre}ctx_enc_{s}.mlp", c - offset[:, :, None, :], ne).amax(-2)
            for s, c in enumerate(crops)]
    cond = torch.relu(p.fc(f"{pre}cond_fc", torch.cat(encs, -1), 0))
    mu, logvar = p.fc(f"{pre}prior.FCLayers_0", cond, 1).chunk(2, dim=-1)
    logvar = torch.clamp(logvar, -10.0, 10.0)
    out = dict(center=center, prior_mu=mu, prior_logvar=logvar)
    if gt_points is not None:
        h = p.mlp(f"{pre}recog_enc.mlp", gt_points - center[:, :, None, :], ne, gt_valid)
        gt_feat = masked_max(h, gt_valid, -2)
        qmu, qlv = p.fc(f"{pre}recognition.FCLayers_0", torch.cat([gt_feat, cond], -1),
                        1).chunk(2, dim=-1)
        out.update(q_mu=qmu, q_logvar=torch.clamp(qlv, -10.0, 10.0))
        mu, logvar = out["q_mu"], out["q_logvar"]
    z = mu + z_eps * torch.exp(0.5 * logvar)
    gen = p.fc(f"{pre}generator", torch.cat([z, cond], -1), len(g["generator_fc"]))
    out["generated"] = gen.reshape(*gen.shape[:-1], g["num_gen_points"], 3) + center[:, :, None, :]
    out["objectness"] = p.fc(f"{pre}objectness", cond, len(g["objectness_fc"]))[..., 0]
    return out


def proposal_boxes(generated, margin: float):
    return torch.cat([generated.amin(-2) - margin, generated.amax(-2) + margin], dim=-1)


# ---------------------------------------------------------------- R-PointNet


def backbone(p: Params, pre: str, r: dict, xyz, valid, sa1_idx):
    """SA x k then FP x k: per-point features ``(B, N, C)``."""
    segs, mode = r["fps_segments"], r["fps_segment_mode"]
    xs, fs, vs = [xyz], [None], [valid]
    for i, (npoint, radius, k, mlp) in enumerate(r["sa_layers"]):
        x, v = xs[-1], vs[-1]
        idx = sa1_idx if i == 0 else ops.fps(
            npoint, x, v, ops.eligible_segments(segs, npoint, x.shape[1]), mode)
        centres = ops.gather_rows(x, idx)
        ((gidx, cnt, local),) = ops.ball_group((radius,), (k,), x, centres, v)
        pts = local if fs[-1] is None else torch.cat([local, ops.gather_rows(fs[-1], gidx)], -1)
        pooled = p.mlp(f"{pre}backbone.sa{i + 1}.mlp", pts, len(mlp)).amax(2)
        nv = cnt > 0
        xs.append(centres)
        fs.append(torch.where(nv[..., None], pooled, torch.zeros_like(pooled)))
        vs.append(nv)
    feat = fs[-1]
    nsa = len(r["sa_layers"])
    for i, mlp in enumerate(r["fp_mlps"]):
        lvl = nsa - 1 - i
        dist, idx = ops.three_nn(xs[lvl], xs[lvl + 1], vs[lvl + 1])
        h = ops.fp_interpolate(feat, idx, dist, fs[lvl])
        h = p.mlp(f"{pre}backbone.fp{i + 1}.mlp", h, len(mlp), vs[lvl])
        feat = torch.where(vs[lvl][..., None], h, torch.zeros_like(h))
    return feat


def roi_heads(p: Params, pre: str, r: dict, xyz, feat, boxes, valid):
    """Point RoIAlign (the first S points in each box, cycled) and the
    heads: ``dict(cls_logits, box_deltas, mask_logits, roi_idx, roi_xyz,
    roi_valid)``."""
    s = r["roi_samples"]
    first, cnt, local = ops.box_group(boxes, s, xyz, valid)
    extent = torch.clamp(boxes[..., 3:6] - boxes[..., 0:3], min=1e-6)
    wrap = torch.remainder(torch.arange(s, device=xyz.device),
                           torch.clamp(cnt, min=1)[..., None])
    idx = torch.gather(first, -1, wrap)
    roi_valid = cnt > 0
    idx = torch.where(roi_valid[..., None], idx, torch.zeros_like(idx))
    canon = torch.gather(local, -2, wrap[..., None].expand(-1, -1, -1, 3)) / extent[..., None, :]
    roi_feats = ops.gather_rows(feat, idx)
    roi_xyz = ops.gather_rows(xyz, idx)
    h = f"{pre}heads."
    pt = p.mlp(h + "roi_mlp", torch.cat([canon, roi_feats], -1), len(r["roi_mlp"]))
    pooled = pt.amax(-2)
    cls_logits = p.fc(h + "cls", pooled, len(r["cls_fc"]))
    box_deltas = p.fc(h + "box", pooled, len(r["box_fc"]))
    per_pt = torch.cat([pt, pooled[..., None, :].expand_as(pt)], -1)
    mask_logits = p.dense(h + "mask_out", p.mlp(h + "mask_mlp", per_pt, len(r["mask_mlp"])))[..., 0]
    return dict(
        cls_logits=torch.where(roi_valid[..., None], cls_logits, torch.zeros_like(cls_logits)),
        box_deltas=box_deltas,
        mask_logits=torch.where(roi_valid[..., None], mask_logits,
                                torch.full_like(mask_logits, -1e4)),
        roi_idx=idx, roi_xyz=roi_xyz, roi_valid=roi_valid)


def apply_box_deltas(boxes, deltas):
    center = (boxes[..., 0:3] + boxes[..., 3:6]) * 0.5
    extent = torch.clamp(boxes[..., 3:6] - boxes[..., 0:3], min=1e-6)
    c = center + deltas[..., 0:3] * extent
    e = extent * torch.exp(torch.clamp(deltas[..., 3:6], -4.0, 4.0))
    return torch.cat([c - e / 2, c + e / 2], dim=-1)


# ---------------------------------------------------------------- the pipeline


def shared_fps(cfg: dict, xyz, valid):
    """One FPS pass giving the proposal seeds and SA1's centres (greedy FPS
    is prefix-consistent): ``(seed_idx, sa1_idx)``."""
    g, r = cfg["gspn"], cfg["rpointnet"]
    sa1 = r["sa_layers"][0][0]
    n = xyz.shape[1]
    segs = g["fps_segments"]
    if any(ops.eligible_segments(segs, k, n) != segs for k in (cfg["num_seeds"], sa1)):
        segs = 1
    idx = ops.fps(max(cfg["num_seeds"], sa1), xyz, valid, segs, g["fps_segment_mode"])
    return idx[:, :cfg["num_seeds"]], idx[:, :sa1]


def infer(cfg: dict, state: dict, xyz, valid, z_eps) -> dict:
    """One request: ``dict(masks (B, R, N), scores, classes, boxes,
    valid)``, R = the seeds."""
    p = Params(state)
    r = cfg["rpointnet"]
    seed_idx, sa1_idx = shared_fps(cfg, xyz, valid)
    out = gspn(p, "gspn.", cfg["gspn"], xyz, seed_idx, valid, z_eps)
    boxes = proposal_boxes(out["generated"], r["box_margin"])
    obj = torch.sigmoid(out["objectness"])
    keep = ops.nms(boxes, obj, r["nms_iou"])
    feat = backbone(p, "rpointnet.", r, xyz, valid, sa1_idx)
    heads = roi_heads(p, "rpointnet.", r, xyz, feat, boxes, valid)
    fg = torch.softmax(heads["cls_logits"], dim=-1)[..., 1:]
    classes = (fg.argmax(-1) + 1).to(torch.int32)
    score = obj * fg.amax(-1)
    refined = apply_box_deltas(boxes, heads["box_deltas"])
    pvalid = keep & heads["roi_valid"] & (score > cfg["score_thresh"])
    logit = ops.nearest_sample_logit(xyz, heads["roi_xyz"], heads["mask_logits"])
    masks = ops.box_contains(refined, xyz, valid) & (torch.sigmoid(logit) > cfg["mask_thresh"])
    return dict(masks=masks & pvalid[..., None],
                scores=torch.where(pvalid, score, torch.zeros_like(score)),
                classes=classes, boxes=refined, valid=pvalid)
