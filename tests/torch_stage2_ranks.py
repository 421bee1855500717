"""The ranks of ``tests/test_torch_stage2_options.py``: stage 2's loss with
non-default ``loss_weights`` and ``gt_box_jitter`` on 2 gloo ranks, the
DP-aware loss (a scene a rank) and the point-sharded loss (a 1-D mesh of
2), and the DP step with and without ``remat``. This module imports no
JAX, so the spawned ranks start without it."""

import pathlib

import torch
import torch.distributed as dist

from gspn_tpu_torch.models import gspn as tg
from gspn_tpu_torch.models import rpointnet as tr
from gspn_tpu_torch.parallel import make_dp_train_step, make_mesh, make_mesh_2d, shard_batch
from gspn_tpu_torch.parallel import make_point_sharded_rpointnet_loss_fn
from gspn_tpu_torch.train import steps as tsteps

W = 2  # ranks


def _models(case, **knobs):
    import dataclasses

    rp = tr.RPointNet(dataclasses.replace(case["rp_cfg"], **knobs))
    rp.load_state_dict(case["rpointnet"])
    gm = tg.GSPN(case["gspn_cfg"])
    gm.load_state_dict(case["frozen"])
    return rp.train(), gm.eval()


def rank_main(rank: int, port: int, work: str) -> None:
    """One rank: writes ``work/rank<r>.pt`` with the DP loss and metrics,
    the point-sharded ones, and the DP step's state with and without
    ``remat``."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=W)
    try:
        work = pathlib.Path(work)
        torch.manual_seed(1234 + rank)  # nothing may depend on the global generator
        torch.set_num_threads(1)
        case = torch.load(work / "case.pt", weights_only=False)
        opts = dict(loss_weights=case["loss_weights"], gt_box_jitter=case["gt_box_jitter"])
        batch, draws, s, inst = case["batch"], case["draws"], case["seeds"], case["instances"]
        out = {}
        mesh = make_mesh("cpu", n_ranks=W)
        model, gm = _models(case)
        dp = tsteps.make_rpointnet_loss_fn(inst, (gm, s), **opts, dp_group=mesh.group,
                                           dp_size=mesh.size)
        total, metrics = dp(model, shard_batch(mesh, batch), **draws)
        out["dp"] = {k: float(v) for k, v in metrics.items()}
        for remat in (False, True):
            model, gm = _models(case, remat=remat)
            loss_fn = tsteps.make_rpointnet_loss_fn(inst, (gm, s), **opts, dp_group=mesh.group,
                                                    dp_size=mesh.size)
            state = tsteps.TrainState(model, tsteps.make_optimizer(model, 1e-3))
            step = make_dp_train_step(loss_fn, mesh)
            losses = [step(state, shard_batch(mesh, batch), **draws)["loss"] for _ in range(2)]
            out[f"dp_remat_{remat}"] = (torch.stack(losses),
                                        {k: v.clone() for k, v in model.state_dict().items()})
        pmesh = make_mesh_2d(1, W, device="cpu")
        model, gm = _models(case)
        ps = make_point_sharded_rpointnet_loss_fn(case["rp_cfg"], pmesh, inst, (gm, s), **opts)
        total, metrics = ps(model, batch, **draws)
        out["point_sharded"] = {k: float(v) for k, v in metrics.items()}
        torch.save(out, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
