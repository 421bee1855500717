"""Inference and evaluation on the card: the port's counterpart of
``python -m gspn_tpu.eval.run_eval``::

    python -m gspn_tpu_torch.eval.run_eval --gspn-ckpt runs/gspn/ckpt \\
        --rpointnet-ckpt runs/rpointnet/ckpt [--dump-dir preds/] [--num-scenes 20]
    python -m gspn_tpu_torch.eval.run_eval --device cpu --preset tiny \\
        --num-scenes 4 --batch 2 --num-points 192 --num-seeds 8 --num-classes 3

Per scene batch: seeds, the GSPN decode (z from the prior), NMS, Point
RoIAlign, the heads and the masks, through ``make_inference_fn`` (or, with
``--artifact``, an exported program replayed by ``InferenceSession``; with
``--point-sharded``, ``parallel.make_point_sharded_inference`` over the
``torch.distributed`` ranks, ``--data-rows`` rows of them taking the
scenes in turn);
then the host-side ScanNet-protocol AP against the GT labels, optionally
with scene-level bootstrap CIs (``--bootstrap``), a paired second arm
(``--ab-*``) and per-scene dumps (``--dump-dir``, npz or the official
ScanNet layout). The scenes: synthetic ones of ``--family``, ScanNet crops
(``--scannet-dir``) or PartNet shapes (``--partnet-dir``), Morton-sorted
with ``--morton``. The JAX eval's flags and defaults, plus ``--device``
(default ``cuda``; without a CUDA device it exits, never falling back to
the CPU).

Every batch takes the same CVAE noise, one draw of ``(batch, num_seeds,
latent_dim)`` from ``serve.runtime.chunk_noise(seed, 0, ...)`` (a ragged
last batch its first rows), as the JAX eval passes one ``PRNGKey(seed)``
to every batch. It is what ``InferenceSession.predict(..., seed=seed)``
feeds an artifact of batch ``--batch``, so ``--artifact`` gives the live
run's summary bit for bit. Under ``--point-sharded`` every rank runs the
loop on that noise and holds every batch's predictions; rank 0 alone
prints and writes the dumps::

    torchrun --nproc-per-node 4 -m gspn_tpu_torch.eval.run_eval --point-sharded \
        --gspn-ckpt runs/gspn/ckpt --rpointnet-ckpt runs/rpointnet/ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
from collections.abc import Callable, Iterable

import numpy as np
import torch

from gspn_tpu_torch.data import native, synthetic
from gspn_tpu_torch.data.layout_probe import warn_if_layout_biased
from gspn_tpu_torch.data.partnet import PartNetParts
from gspn_tpu_torch.data.scannet import ScanNetCrops
from gspn_tpu_torch.eval import instance_eval as ie
from gspn_tpu_torch.eval.scannet_export import write_scannet_submission
from gspn_tpu_torch.models.gspn import GSPNConfig
from gspn_tpu_torch.models.pipeline import (
    PipelineConfig,
    PipelineModel,
    init_pipeline_variables,
    make_inference_fn,
)
from gspn_tpu_torch.models.presets import (
    scale_pipeline_widths,
    set_pipeline_dtype,
    set_pipeline_fps_segments,
    set_pipeline_group_select,
)
from gspn_tpu_torch.models.rpointnet import RPointNetConfig
from gspn_tpu_torch.parallel import PointMesh, make_mesh_2d, make_point_sharded_inference
from gspn_tpu_torch.serve.runtime import chunk_noise, float32_matmuls, restore_checkpoints
from gspn_tpu_torch.train.train_gspn import (
    TINY_GSPN,
    batch_feature_dim,
    resolve_device,
)
from gspn_tpu_torch.train.train_rpointnet import tiny_rpointnet


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GSPN instance-seg evaluation")
    p.add_argument("--gspn-ckpt", type=str, default=None,
                   help="train_gspn's checkpoint directory ({log_dir}/ckpt)")
    p.add_argument("--rpointnet-ckpt", type=str, default=None,
                   help="train_rpointnet's checkpoint directory ({log_dir}/ckpt)")
    p.add_argument("--scannet-dir", type=str, default=None,
                   help="preprocessed ScanNet scenes (data.preprocess_scannet's .npz)")
    p.add_argument("--partnet-dir", type=str, default=None,
                   help="PartNet ins_seg h5 dir (part instances)")
    p.add_argument("--num-scenes", type=int, default=16)
    p.add_argument("--family", choices=sorted(synthetic.FAMILIES), default="default",
                   help="synthetic generator family (data/synthetic.py FAMILIES)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--num-points", type=int, default=4096)
    p.add_argument("--morton", action="store_true",
                   help="Morton-sort each scene's points (AP is unchanged: masks and labels "
                        "permute together)")
    p.add_argument("--num-seeds", type=int, default=64)
    p.add_argument("--num-classes", type=int, default=18)
    p.add_argument("--dump-dir", type=str, default=None)
    p.add_argument("--dump-format", choices=["npz", "scannet"], default="npz",
                   help="a compact .npz a scene, or the official ScanNet submission layout "
                        "(a .txt a scene + predicted_masks/)")
    p.add_argument("--point-sharded", action="store_true",
                   help="shard each scene's points, seeds and RoIs over the torch.distributed "
                        "ranks (parallel/scene.py)")
    p.add_argument("--data-rows", type=int, default=0,
                   help="with --point-sharded: a 2-D mesh, the scenes split over this many "
                        "rows of ranks (must divide --batch)")
    p.add_argument("--artifact", type=str, default=None,
                   help="serve the eval from an artifact of gspn_tpu_torch.serve.export_serving "
                        "(its batch and point count must be --batch and --num-points)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--preset", choices=["default", "tiny"], default="default")
    p.add_argument("--width-mult", type=int, default=1,
                   help="MLP width multiplier: the value the checkpoints were trained with")
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                   help="MLP and head compute dtype (parameters stay float32)")
    p.add_argument("--fps-segments", type=int, default=None,
                   help="segmented parallel-chain FPS (default: the preset's); 1 forces the "
                        "exact greedy FPS")
    p.add_argument("--fps-segment-mode", choices=["contiguous", "strided", "spatial"],
                   default="spatial")
    p.add_argument("--sa1-fps-segments", type=int, default=None,
                   help="a backbone-sa1 FPS pass of its own at this segment count (>0)")
    p.add_argument("--group-select", choices=["first", "strided"], default=None,
                   help="neighbourhood and RoI K-selection (default: the preset's, 'first')")
    p.add_argument("--mask-project-prune", choices=["auto", "off"], default=None,
                   help="box-pruned mask projection over the spatial FPS's Morton view "
                        "(default: the preset's, 'off')")
    p.add_argument("--ab-fps-segments", type=int, default=None,
                   help="paired A/B: a second arm with this fps_segments on the same scenes, "
                        "and the scene-paired bootstrap CI of the AP difference (main - arm "
                        "B); needs --bootstrap > 0")
    p.add_argument("--ab-fps-segment-mode", choices=["contiguous", "strided", "spatial"],
                   default="spatial")
    p.add_argument("--ab-sa1-fps-segments", type=int, default=None,
                   help="paired A/B: arm B also sets sa1_fps_segments to this value")
    p.add_argument("--ab-group-select", choices=["first", "strided"], default=None,
                   help="paired A/B: arm B also sets group_select to this value")
    p.add_argument("--box-percentile", type=float, default=0.0,
                   help=">0: outlier-trimmed proposal box extents")
    p.add_argument("--score-thresh", type=float, default=0.05)
    p.add_argument("--min-region-size", type=int, default=0,
                   help="exclude GT instances below this size (the official protocol: 100)")
    p.add_argument("--void-forgive", action="store_true",
                   help="ignore unmatched predictions mostly on unannotated points")
    p.add_argument("--bootstrap", type=int, default=0,
                   help=">0: scene-level bootstrap with this many replicates (ap*_ci95)")
    p.add_argument("--match", choices=["greedy", "per_gt"], default="greedy",
                   help="duplicate-prediction resolution: greedy or per_gt (the official rule)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) exits when there is no CUDA device")
    args = p.parse_args(argv)
    if args.scannet_dir and args.partnet_dir:
        p.error("--scannet-dir and --partnet-dir are mutually exclusive")
    if args.artifact and args.point_sharded:
        p.error("--artifact and --point-sharded are mutually exclusive "
                "(the artifact is a fixed single-program export)")
    if args.data_rows and not args.point_sharded:
        p.error("--data-rows requires --point-sharded")
    if args.data_rows and args.batch % args.data_rows:
        p.error(f"--batch {args.batch} must be divisible by --data-rows {args.data_rows}")
    if (args.artifact or args.data_rows) and args.num_scenes % args.batch:
        p.error(f"--num-scenes {args.num_scenes} must be a multiple of --batch {args.batch} "
                "with --artifact/--data-rows (fixed-shape serving paths cannot take a ragged "
                "final batch)")
    # flag combinations fail here, before checkpoints restore and kernels build
    if ab_requested(args):
        if args.point_sharded or args.artifact:
            p.error("the --ab-* knobs run a second live arm and are incompatible with "
                    "--point-sharded / --artifact")
        if args.bootstrap <= 0:
            p.error("the --ab-* knobs report a paired bootstrap CI; pass --bootstrap N "
                    "(e.g. 100)")
    return args


def ab_requested(args) -> bool:
    return (args.ab_fps_segments is not None or args.ab_sa1_fps_segments is not None
            or args.ab_group_select is not None)


def build_config(args) -> PipelineConfig:
    """The eval's pipeline: the preset at ``--num-seeds``, ``--num-classes``,
    ``--box-percentile`` and ``--score-thresh``, then ``--width-mult``,
    ``--dtype`` and the FPS, selection and pruning flags, as the JAX eval
    sets them."""
    if args.preset == "tiny":
        gspn, rpointnet = TINY_GSPN, tiny_rpointnet(args.num_classes)
    else:
        gspn, rpointnet = GSPNConfig(), RPointNetConfig(num_classes=args.num_classes)
    cfg = PipelineConfig(gspn=gspn, rpointnet=rpointnet, num_seeds=args.num_seeds,
                         box_percentile=args.box_percentile, score_thresh=args.score_thresh)
    if args.width_mult != 1:
        cfg = scale_pipeline_widths(cfg, args.width_mult)
    if args.dtype == "bf16":
        cfg = set_pipeline_dtype(cfg, torch.bfloat16)
    if args.fps_segments is not None:
        cfg = set_pipeline_fps_segments(cfg, args.fps_segments, args.fps_segment_mode)
    if args.sa1_fps_segments is not None:
        cfg = dataclasses.replace(cfg, sa1_fps_segments=args.sa1_fps_segments)
    if args.group_select is not None:
        cfg = set_pipeline_group_select(cfg, args.group_select)
    if args.mask_project_prune is not None:
        cfg = dataclasses.replace(cfg, mask_project_prune=args.mask_project_prune)
    return cfg


def ab_config(cfg: PipelineConfig, args) -> PipelineConfig | None:
    """The paired arm B: ``cfg`` with the ``--ab-*`` knobs, or None."""
    if not ab_requested(args):
        return None
    if args.ab_fps_segments is not None:
        cfg = set_pipeline_fps_segments(cfg, args.ab_fps_segments, args.ab_fps_segment_mode)
    if args.ab_sa1_fps_segments is not None:
        cfg = dataclasses.replace(cfg, sa1_fps_segments=args.ab_sa1_fps_segments)
    if args.ab_group_select is not None:
        cfg = set_pipeline_group_select(cfg, args.ab_group_select)
    return cfg


def with_feature_dim(cfg: PipelineConfig, fdim: int) -> PipelineConfig:
    """``cfg`` with both stages at the data's feature width ``fdim``."""
    if fdim == cfg.gspn.feature_dim == cfg.rpointnet.feature_dim:
        return cfg
    return dataclasses.replace(cfg, gspn=dataclasses.replace(cfg.gspn, feature_dim=fdim),
                               rpointnet=dataclasses.replace(cfg.rpointnet, feature_dim=fdim))


def scene_batches(args) -> Callable[[], Iterable[dict]]:
    """The eval's data source: a function whose every call yields the same
    ``--num-scenes`` scenes from a fresh ``default_rng(seed)``, ``--batch``
    at a time (the last batch ragged), as dicts of numpy arrays: ScanNet
    crops (``--scannet-dir``; their ``scene_ids`` ride along, and
    ``--morton`` sorts inside the crop), PartNet shapes (``--partnet-dir``)
    or synthetic scenes of ``--family``; ``--morton`` sorts the latter two
    with ``native.morton_sort_batch``, as the JAX eval does."""
    if args.scannet_dir:
        sample = ScanNetCrops(args.scannet_dir, num_points=args.num_points,
                              morton=args.morton).sample_batch
    elif args.partnet_dir:
        sample = PartNetParts(args.partnet_dir, num_points=args.num_points).sample_batch
    else:
        fam_kw = dict(synthetic.FAMILIES[args.family])
        fam_kw.setdefault("max_instances", 8)

        def sample(rng, b):
            return synthetic.scene_batch(rng, b, n_points=args.num_points, **fam_kw)
    sort = args.morton and not args.scannet_dir

    def batches():
        rng = np.random.default_rng(args.seed)
        done = 0
        while done < args.num_scenes:
            b = min(args.batch, args.num_scenes - done)
            batch = sample(rng, b)
            yield native.morton_sort_batch(batch) if sort else batch
            done += b

    return batches


def check_checkpoint_config(ckpt_dir: str, name: str, fdim: int, cfg=None) -> None:
    """Refuse a checkpoint whose run's ``config.json`` (the trainers write it
    beside ``ckpt/``) disagrees with the eval's feature width or, given the
    stage config ``cfg`` about to take its weights, with its width-signature
    fields: a clear ``ValueError`` instead of a shape error at restore."""
    cfg_path = pathlib.Path(ckpt_dir).parent / "config.json"
    if not cfg_path.exists():
        return
    try:
        saved = json.loads(cfg_path.read_text()).get("model", {})
    except (json.JSONDecodeError, OSError):
        return
    saved_fdim = saved.get("feature_dim")
    if saved_fdim is not None and int(saved_fdim) != fdim:
        raise ValueError(
            f"{name} checkpoint {ckpt_dir} was trained with feature_dim={saved_fdim} but the "
            f"eval data has feature_dim={fdim}; point the eval at data matching the training "
            "features")
    if cfg is None:
        return
    for key in ("encoder_mlp", "cond_dim", "roi_mlp", "fp_mlps"):
        saved_v = saved.get(key)
        cur = getattr(cfg, key, None)
        if saved_v is None or cur is None:
            continue
        norm = json.loads(json.dumps(cur if isinstance(cur, int) else [
            list(x) if isinstance(x, (list, tuple)) else x for x in cur]))
        if norm != saved_v:
            raise ValueError(
                f"{name} checkpoint {ckpt_dir} was trained with {key}={saved_v} but the eval "
                f"config has {norm} — pass the same --width-mult/--preset the checkpoint was "
                "trained with")


@dataclasses.dataclass
class EvalRun:
    """What :func:`evaluate` collected: each scene's predictions (arm B's
    too when there is one) and ground truth, and the points a second of
    every batch but the first."""

    preds: list[ie.ScenePredictions]
    gts: list[ie.SceneGT]
    preds_b: list[ie.ScenePredictions] | None
    points_per_sec: float


def evaluate(infer, batches: Iterable[dict], z_eps: torch.Tensor, infer_b=None,
             dump_dir: str | pathlib.Path | None = None, dump_format: str = "npz") -> EvalRun:
    """The evaluation loop. ``infer(xyz, valid, z_eps)`` (and ``infer_b``,
    the paired arm; both also given ``features=`` where the batches carry
    per-point features) runs one batch on ``z_eps``'s device and returns the
    port's predictions in any form ``instance_eval.predictions_from_device``
    takes; every batch of ``b`` scenes gets ``z_eps[:b]``. Runs under
    ``torch.inference_mode`` with float32 matmuls. The first batch (which
    pays the kernels' build or the graph's capture) is left out of the
    points a second. Dumps each scene's predictions under ``dump_dir``,
    named by the batch's ``scene_ids`` (ScanNet crops) or ``scene_<i>``;
    a name seen before (scenes are drawn with replacement) gets
    ``__crop<k>`` for its k-th repeat, as in the JAX eval."""
    preds, gts = [], []
    preds_b = [] if infer_b is not None else None
    infer_s, infer_pts, scene_i = 0.0, 0, 0
    dumped: dict[str, int] = {}
    dump_dir = pathlib.Path(dump_dir) if dump_dir else None
    if dump_dir:
        dump_dir.mkdir(parents=True, exist_ok=True)
    with torch.inference_mode(), float32_matmuls():
        for batch in batches:
            xyz = torch.from_numpy(batch["xyz"]).to(z_eps.device)
            valid = torch.from_numpy(batch["valid"]).to(z_eps.device)
            eps = z_eps[: xyz.shape[0]]
            feats = batch.get("features")
            kw = ({"features": torch.from_numpy(feats).to(z_eps.device)}
                  if feats is not None and feats.shape[-1] else {})
            t0 = time.perf_counter()
            scenes = ie.predictions_from_device(infer(xyz, valid, eps, **kw),
                                                batch["valid"])  # syncs
            if scene_i > 0:
                infer_s += time.perf_counter() - t0
                infer_pts += int(batch["valid"].size)
            if infer_b is not None:  # the paired arm: the same batch and noise
                preds_b.extend(ie.predictions_from_device(infer_b(xyz, valid, eps, **kw),
                                                          batch["valid"]))
            for bi, sp in enumerate(scenes):
                v = batch["valid"][bi]
                preds.append(sp)
                gts.append(ie.gt_from_labels(batch["inst_label"][bi][v],
                                             batch["sem_label"][bi][v]))
                if dump_dir:
                    ids = batch.get("scene_ids")
                    scene_id = ids[bi] if ids is not None else f"scene_{scene_i:05d}"
                    seen = dumped.get(scene_id, 0)
                    dumped[scene_id] = seen + 1
                    if seen:
                        scene_id = f"{scene_id}__crop{seen}"
                    if dump_format == "scannet":
                        write_scannet_submission(dump_dir, scene_id, sp)
                    else:
                        np.savez_compressed(dump_dir / f"{scene_id}.npz", masks=sp.masks,
                                            scores=sp.scores, classes=sp.classes)
                scene_i += 1
    return EvalRun(preds, gts, preds_b, round(infer_pts / max(infer_s, 1e-9), 1))


def summarize(run: EvalRun, args) -> tuple[dict, dict]:
    """``(summary, result)``: the JAX eval's summary line (``scenes``, AP,
    AP50, AP25, ``points_per_sec``; ``*_ci95`` with ``--bootstrap``; arm
    B's APs and the paired ``*_diff`` fields with an ``--ab-*`` arm) and
    ``evaluate_instances``' result, per class included."""
    class_ids = sorted({c for gt in run.gts for c in gt.inst_class.values()})
    if not class_ids:
        class_ids = list(range(1, args.num_classes + 1))
    kw = dict(min_region_size=args.min_region_size, void_forgive=args.void_forgive,
              match=args.match)
    res = ie.evaluate_instances(run.preds, run.gts, class_ids, **kw)
    summary = {"scenes": len(run.preds), "ap": res["ap"], "ap_50": res["ap_50"],
               "ap_25": res["ap_25"], "points_per_sec": run.points_per_sec}
    if args.bootstrap > 0:
        cis = ie.bootstrap_ci(run.preds, run.gts, class_ids, n_boot=args.bootstrap,
                              seed=args.seed, **kw)
        for k, (lo, hi) in cis.items():
            summary[f"{k}_ci95"] = [round(lo, 4), round(hi, 4)]
    if run.preds_b is not None:
        res_b = ie.evaluate_instances(run.preds_b, run.gts, class_ids, **kw)
        for k in ("ap", "ap_50", "ap_25"):
            summary[f"{k}_armB"] = res_b[k]
        diff = ie.bootstrap_diff(run.preds, run.preds_b, run.gts, class_ids,
                                 n_boot=args.bootstrap, seed=args.seed, **kw)
        for k, v in diff.items():
            summary[k] = [round(v[0], 4), round(v[1], 4)] if isinstance(v, tuple) else round(v, 4)
    return summary, res


def live_infer(cfg: PipelineConfig, state: dict, device, mesh: PointMesh | None = None):
    """``infer(xyz, valid, z_eps, features=None)`` of a
    :class:`PipelineModel` built from ``cfg`` with ``state``'s weights, on
    ``device`` in eval mode; with a ``mesh``, point-sharded over it
    (``parallel.make_point_sharded_inference``)."""
    model = PipelineModel(cfg)
    model.load_state_dict(state)
    model = model.to(device).eval()
    if mesh is not None:
        sharded = make_point_sharded_inference(cfg, mesh)
        return lambda xyz, valid, z_eps, features=None: sharded(model, xyz, valid, z_eps,
                                                                features=features)
    fn = make_inference_fn(cfg)
    return lambda xyz, valid, z_eps, features=None: fn(model, xyz, valid, z_eps=z_eps,
                                                       features=features)


def artifact_infer(path: str, cfg: PipelineConfig, state: dict, args, device):
    """``infer(xyz, valid, z_eps, features=None)``: ``InferenceSession.run`` of the artifact
    at ``path`` with ``state``'s weights (on the card a CUDA graph's
    replay). Refuses an artifact exported for another seed count, batch or
    point count than the eval's."""
    from gspn_tpu_torch.serve.export import load_artifact
    from gspn_tpu_torch.serve.runtime import InferenceSession

    program, manifest = load_artifact(path, device)
    saved_seeds = manifest.get("pipeline_config", {}).get("num_seeds")
    if saved_seeds is not None and int(saved_seeds) != cfg.num_seeds:
        raise ValueError(f"artifact was exported with num_seeds={saved_seeds}, eval is "
                         f"configured with {cfg.num_seeds}")
    shape = tuple(manifest["inputs"]["xyz"][:2])
    if shape != (args.batch, args.num_points):
        raise ValueError(f"artifact was exported for batch x points {shape}, eval runs "
                         f"--batch {args.batch} --num-points {args.num_points}")
    print(f"serving from {path} (platforms={manifest.get('platforms')})")
    return InferenceSession(path, state, device=device, loaded=(program, manifest)).run


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device, "run_eval")
    mesh = make_mesh_2d(args.data_rows or 1, device=device) if args.point_sharded else None
    try:
        return _run(args, device if mesh is None else mesh.device, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _run(args, device, mesh: PointMesh | None) -> dict:
    writer = mesh is None or mesh.rank == 0
    cfg = build_config(args)
    batches = scene_batches(args)
    first = next(iter(batches()))
    if cfg.gspn.group_select == "first" and writer:  # warn when the layout is first-K's pathology
        mid = min(1, len(cfg.gspn.context_radii) - 1)
        warn_if_layout_biased(first, radius=float(cfg.gspn.context_radii[mid]),
                              k=int(cfg.gspn.context_nsample[mid]), where="eval data")
    n = first["xyz"].shape[1]
    fdim = batch_feature_dim(first)
    cfg = with_feature_dim(cfg, fdim)  # both stages read the data's features
    state = init_pipeline_variables(cfg, torch.Generator().manual_seed(args.seed), n)
    for name, ckpt in (("gspn", args.gspn_ckpt), ("rpointnet", args.rpointnet_ckpt)):
        if ckpt:
            check_checkpoint_config(ckpt, name, fdim, getattr(cfg, name))
            restore_checkpoints(state, **{f"{name}_ckpt": ckpt})
            if writer:
                print(f"restored {name} from {ckpt}")

    if args.artifact:
        infer = artifact_infer(args.artifact, cfg, state, args, device)
    else:
        infer = live_infer(cfg, state, device, mesh)
    cfg_b = ab_config(cfg, args)
    infer_b = live_infer(cfg_b, state, device) if cfg_b is not None else None
    z_eps = chunk_noise(args.seed, 0, (args.batch, cfg.num_seeds, cfg.gspn.latent_dim))
    run = evaluate(infer, batches(), z_eps.to(device), infer_b,
                   args.dump_dir if writer else None, args.dump_format)
    summary, res = summarize(run, args)
    if writer:
        print(json.dumps(summary))
    return res


if __name__ == "__main__":
    main()
