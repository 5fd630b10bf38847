"""Dry run of both multi-device flavours at tiny shapes, and the one-step
render check (the port's counterpart of the JAX package's
`__graft_entry__.entry` and `dryrun_multichip`).

    python -m loopy_slam_torch.parallel.dryrun [--ranks N] [--device cpu]

On n ranks: one ray-DP mapping chunk (3 geometry + 3 color iterations,
16 rays a rank) and one map-shard chunk (2 + 2) on a map of the synthetic
room's first frame; each loss is held against a single-device chunk of
the same ray budget (bands 0.2-5 for ray-DP and 0.05-20 for map-shard:
the per-rank pixels differ from the single device's by design, so the
check is statistical: a double sum, a lost rank or a NaN leaves the band).
Prints `MULTICHIP_COST {json}`: the chunks' warm wall times on this
machine, the losses, and the per-iteration collective bytes of
parallel/cost_model.py at the dry run's and the bench's shapes.
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np
import torch

from .. import resolve_device
from ..config import DEFAULTS, update_recursive
from ..mapping import mapper as mapper_mod
from ..mapping.point_cloud import MapOptions, init_map, valid_mask
from ..models.decoder import init_decoders, trainable_mask
from ..models.renderer import RenderOptions, render_batch_ray
from ..ops.camera import get_rays
from ..ops.draws import TorchDraws
from ..utils.datasets import Synthetic
from . import cost_model as cm
from . import map_shard as msh
from .mesh import launch
from .sharded import sharded_optimize_map


def tiny_cfg():
    cfg = copy.deepcopy(DEFAULTS)
    update_recursive(cfg, {
        "dataset": "synthetic",
        "use_dynamic_radius": False,
        "cam": {"H": 48, "W": 64, "fx": 48.0, "fy": 48.0,
                "cx": 31.5, "cy": 23.5, "crop_edge": 0},
        "data": {"n_frames": 4},
        "rendering": {"sample_near_pcl": False},
        "pointcloud": {"capacity": 4096, "cell_table_size": 2 ** 14,
                       "max_per_cell": 16, "radius_add": 0.1,
                       "radius_query": 0.2},
    })
    return cfg


def build_scene(cfg, device):
    """Frame 0 of the synthetic room, its map (1024 sampled pixels inserted)
    and fresh decoders, all from seeded draws."""
    ds = Synthetic(cfg)
    _, color, depth, c2w = ds[0]
    mopts_map = MapOptions.from_cfg(cfg)
    mopts = mapper_mod.MapperOptions.from_cfg(cfg)
    draw = TorchDraws(1, device)
    state = init_map(mopts_map, device=device)
    dec = init_decoders(TorchDraws(0, device).gen, cfg, device)
    c2w_t = torch.as_tensor(c2w, device=device)
    state, _ = mapper_mod.add_points_from_frame(
        state, torch.as_tensor(color, device=device),
        torch.as_tensor(depth, device=device), c2w_t, c2w_t, draw,
        mopts_map, mopts, 1024, overlap=None)
    return ds, state, dec, mopts, c2w


def entry(device=None):
    """(fn, args): one color-stage render of a 16x16 ray block through the
    tiny map (the single-device compile check)."""
    dev = resolve_device(device)
    cfg = tiny_cfg()
    ds, state, dec, _, c2w = build_scene(cfg, dev)
    _, _, depth, _ = ds[0]
    c = cfg["cam"]
    rays_o, rays_d = get_rays(16, 16, c["fx"], c["fy"], c["cx"], c["cy"],
                              torch.as_tensor(c2w, device=dev))
    gt = torch.as_tensor(depth[:16, :16], device=dev).reshape(-1)
    ropts = RenderOptions.from_cfg(cfg)

    def fn(dec, pos, grid, feat, rays_o, rays_d, gt_depth, draw):
        return render_batch_ray(dec, pos, grid, feat, rays_o, rays_d,
                                gt_depth, gt_depth > 0, draw, ropts, "color")

    return fn, (dec, state.pos, state.grid, state.feat, rays_o.reshape(-1, 3),
                rays_d.reshape(-1, 3), gt, TorchDraws(2, dev))


def _rank(mesh):
    """One rank of the dry run; rank 0's result is the cost record."""
    n, dev = mesh.size(), mesh.device
    cfg = tiny_cfg()
    ds, state, dec0, mopts, c2w = build_scene(cfg, dev)
    _, color, depth, _ = ds[0]
    ropts = RenderOptions.from_cfg(cfg)
    dec_mask = trainable_mask(dec0, cfg)
    kc = torch.as_tensor(color, device=dev)[None]
    kd = torch.as_tensor(depth, device=dev)[None]
    kp = torch.as_tensor(np.asarray(c2w)[None, :3, :], device=dev)
    lrs = [0.005, 0.005, 0.005]
    ppf = 16 * n

    def chunk(fn, draw, n_geo, n_col, feat, feat_mask, *where):
        dec = copy.deepcopy(dec0)  # every chunk starts from the same state
        t0 = time.perf_counter()
        feat, _, aux = fn(dec, feat.clone(), None, dec_mask, feat_mask,
                          *where, kc, kd, kp, draw, n_geo, n_col, lrs, lrs,
                          mopts, ropts, ppf)[:3]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        loss = float(aux[0]) + float(aux[1])
        if not np.isfinite(loss):
            raise AssertionError("a dry-run chunk produced a non-finite loss")
        return loss, time.perf_counter() - t0

    own = TorchDraws(1000 + mesh.rank, dev)
    fm = valid_mask(state)
    dp = (lambda *a: sharded_optimize_map(mesh, *a))  # noqa: E731
    chunk(dp, own, 3, 3, state.feat, fm, state.pos, state.grid)  # warm
    loss_dp, dp_wall = chunk(dp, own, 3, 3, state.feat, fm, state.pos,
                             state.grid)
    loss_sd, _ = chunk(mapper_mod.optimize_map, TorchDraws(7, dev), 3, 3,
                       state.feat, fm, state.pos, state.grid)
    ratio = loss_dp / max(loss_sd, 1e-9)
    if not 0.2 < ratio < 5.0:
        raise AssertionError(f"ray-DP loss {loss_dp:.4f} vs single-device "
                             f"{loss_sd:.4f}: outside the 0.2-5 band")

    cnt = int(state.count)
    mopts_map = MapOptions.from_cfg(cfg)
    cap_l = state.pos.shape[0]
    smap = msh.scatter_from_host(mesh, state.pos[:cnt].cpu().numpy(),
                                 state.feat[:cnt].cpu().numpy(), cap_l,
                                 mopts_map, dev)
    sfm = torch.arange(cap_l, device=dev) < smap.count
    ms = (lambda dec, f, st, dm, m, *a: msh.map_shard_optimize(  # noqa: E731
        mesh, dec, f, st, dm, m, smap, *a))
    chunk(ms, own, 2, 2, smap.feat, sfm)  # warm
    loss_ms, ms_wall = chunk(ms, own, 2, 2, smap.feat, sfm)
    ratio2 = loss_ms / max(loss_sd, 1e-9)
    if not 0.05 < ratio2 < 20.0:
        raise AssertionError(f"map-shard loss {loss_ms:.4f} vs single-device "
                             f"{loss_sd:.4f}: outside the 0.05-20 band")

    trainable = {"dec": list(dec0.parameters()), "feat": state.feat}
    q_local = (ppf // n) * ropts.n_surface
    return {
        "n_devices": n, "backend": mesh.backend,
        "dp_chunk_wall_s": dp_wall, "dp_iter_wall_s": dp_wall / 6,
        "mshard_chunk_wall_s": ms_wall, "mshard_iter_wall_s": ms_wall / 4,
        "loss_dp": loss_dp, "loss_mshard": loss_ms,
        "loss_single_device": loss_sd,
        "dp_iter_MB_per_chip_dryrun": cm.dp_iter_bytes_per_chip(
            trainable, n) / 1e6,
        "mshard_iter_MB_per_chip_dryrun": cm.mshard_iter_bytes_per_chip(
            q_local, ropts.nn_num, 2 * ropts.c_dim,
            cm.tree_bytes(trainable["dec"]), n) / 1e6,
        **cm.bench_budget(n),
    }


def dryrun(n_ranks: int = 2, device=None, store_dir=None) -> dict:
    """Run the dry run on n spawned ranks; prints and returns rank 0's
    MULTICHIP_COST record."""
    record = launch(_rank, n_ranks, device=device, timeout_s=300.0,
                    store_dir=store_dir)[0]
    print("MULTICHIP_COST " + json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    dryrun(a.ranks, a.device)
