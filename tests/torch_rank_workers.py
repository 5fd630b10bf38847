"""Rank bodies of the port's multi-device tests. The ranks are spawned
processes (parallel/mesh.launch), which re-import the module that holds
their function: this one imports torch and the port only, never jax.
Inputs and results are numpy (dicts), made and compared by the tests."""

import numpy as np
import torch

from loopy_slam_torch.convert import decoders_from_numpy
from loopy_slam_torch.mapping.point_cloud import MapOptions
from loopy_slam_torch.models.renderer import RenderOptions
from loopy_slam_torch.ops.draws import ReplayDraws, TorchDraws
from loopy_slam_torch.parallel import map_shard as msh


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(t):
    return t.detach().cpu().numpy().copy()  # not a view of a live tensor


def _shard_dict(s):
    return {"pos": _np(s.pos), "feat": _np(s.feat), "count": int(s.count),
            "cell_data": _np(s.grid.cell_data),
            "cell_fill": _np(s.grid.cell_fill),
            "n_dropped": int(s.grid.n_dropped)}


def primitives(mesh, inp):
    """Owner ids, insertion, ring k-NN, ring fetch and its gradient, the
    sharded eval_points, and the session helpers (transform, grow,
    scatter, gather) on this rank's shard of inp's scene."""
    torch.set_flush_denormal(True)
    r, n = mesh.rank, mesh.size()
    mopts = MapOptions(**inp["mopts"])
    out = {"owner_cells": _np(msh.owner_of_cells(_t(inp["ijk"]), n)),
           "owner_points": _np(msh.owner_of_points(_t(inp["pts"]),
                                                   mopts.cell_size, n))}
    s = msh.init_sharded_map(inp["cap_l"], mopts, "cpu")
    s = msh.shard_insert(s, mesh, _t(inp["pts"]), _t(inp["feats"]),
                         torch.ones(len(inp["pts"]), dtype=torch.bool),
                         mopts.cell_size)
    out["insert"] = _shard_dict(s)

    Qd = inp["q"].shape[0] // n
    q = _t(inp["q"][r * Qd:(r + 1) * Qd])
    rad = (_t(inp["radii"][r * Qd:(r + 1) * Qd]) if inp["extras"]
           else inp["radius"])
    D, I, O, nn = msh.ring_knn(s, mesh, q, inp["k"], rad)
    out["knn"] = [_np(D), _np(I), _np(O), _np(nn)]
    feat = s.feat.clone().requires_grad_(True)
    both = msh.ring_fetch(feat, s.pos, I, O, mesh)
    out["fetch"] = _np(both)
    (g,) = torch.autograd.grad(
        torch.sum(both * _t(inp["cot"][r * Qd:(r + 1) * Qd])), feat)
    out["feat_grad"] = _np(g)

    if inp["extras"]:
        dec = decoders_from_numpy(inp["params"], "cpu", bf16_trunks=False)
        qe = _t(inp["q_eval"][r * Qd:(r + 1) * Qd])
        occ, rgb, hn = msh.ring_eval_points(
            s, mesh, dec, qe, ReplayDraws(inp["eval_draws"][r], "cpu"),
            RenderOptions(**inp["ropts"]), "color")
        out["eval"] = [_np(occ), _np(rgb), _np(hn)]

    N = _t(inp["N"])
    out["transform"] = _shard_dict(msh.shard_transform(s, N, mopts))
    out["grow"] = _shard_dict(msh.grow_sharded(s, 2 * inp["cap_l"], mopts))
    pos, feat, counts = msh.gather_host(s, mesh)
    out["gather"] = [_np(pos), _np(feat), counts]
    out["scatter"] = _shard_dict(msh.scatter_from_host(
        mesh, inp["pts"], inp["feats"], inp["cap_l"], mopts, "cpu"))
    return out


def map_shard_chunk(mesh, inp):
    """One map-shard optimize_map chunk from the scattered scene, with
    this rank's replayed draws. Returns (feat, decoder params, aux)."""
    from loopy_slam_torch.mapping.mapper import MapperOptions
    from loopy_slam_torch.models.decoder import trainable_mask

    torch.set_flush_denormal(True)
    mopts_map = MapOptions(**inp["mopts_map"])
    s = msh.scatter_from_host(mesh, inp["pos"], inp["feat"], inp["cap_l"],
                              mopts_map, "cpu")
    dec = decoders_from_numpy(inp["params"], "cpu", bf16_trunks=False)
    fm = torch.arange(inp["cap_l"]) < s.count
    feat, _, aux = msh.map_shard_optimize(
        mesh, dec, s.feat, None, trainable_mask(dec, inp["cfg"]), fm, s,
        _t(inp["kc"]), _t(inp["kd"]), _t(inp["kp"]),
        ReplayDraws(inp["draws"][mesh.rank], "cpu"), inp["n_geo"],
        inp["n_col"], inp["lrs_geo"], inp["lrs_col"],
        MapperOptions(**inp["mopts"]), RenderOptions(**inp["ropts"]),
        inp["ppf"])
    out = {"feat": _np(feat), "count": int(s.count),
           "dec": {k: _np(p) for k, p in dec.named_parameters()},
           "aux": [float(a) for a in aux]}

    # sample_near_pcl's ring probe against the single-map probe over the
    # gathered points, then a chunk with it and bundle adjustment
    from loopy_slam_torch.ops import knn
    from loopy_slam_torch.ops.camera import tensor_from_c2w

    ropts = RenderOptions(**inp["ropts"])._replace(sample_near_pcl=True)
    pos, _, _ = msh.gather_host(s, mesh)
    grid = knn.build(pos, torch.ones(len(pos), dtype=torch.bool),
                     mopts_map.cell_size, mopts_map.table_size,
                     mopts_map.max_per_cell)
    pts = _t(inp["probe_pts"])
    _, _, nn = knn.query(grid, pos, pts, 1, ropts.radius_query)
    probe = msh.eval_fn_builder(s, mesh, ropts)(dec, s.feat)
    out["probe_equal"] = bool(torch.equal(probe.probe_occupied(pts), nn > 0))
    out["probe_hits"] = int((nn > 0).sum())
    cams0 = torch.stack([_t(tensor_from_c2w(c)) for c in inp["kp"]])
    feat, _, aux, cams = msh.map_shard_optimize(
        mesh, dec, s.feat, None, trainable_mask(dec, inp["cfg"]), fm, s,
        _t(inp["kc"]), _t(inp["kd"]), _t(inp["kp"]),
        TorchDraws(90 + mesh.rank, "cpu"), 1, 1, inp["lrs_geo"],
        inp["lrs_col"], MapperOptions(**inp["mopts"]), ropts, inp["ppf"],
        cams=cams0, ba_row_mask=[0.0, 1.0], ba_lr=0.001,
        ba_window=(0.0, 2.0), iter_offset=0)
    out["ba"] = {"aux": [float(a) for a in aux], "cams": _np(cams),
                 "cams0": _np(cams0), "finite": bool(torch.isfinite(feat)
                                                     .all())}
    return out


def ray_dp_chunk(mesh, inp):
    """One ray-DP optimize_map chunk on the replicated scene, with this
    rank's replayed draws."""
    from loopy_slam_torch.convert import map_state_from_numpy
    from loopy_slam_torch.mapping.mapper import MapperOptions
    from loopy_slam_torch.models.decoder import trainable_mask
    from loopy_slam_torch.parallel.sharded import sharded_optimize_map

    torch.set_flush_denormal(True)
    st = map_state_from_numpy(*inp["state"], device="cpu")
    dec = decoders_from_numpy(inp["params"], "cpu", bf16_trunks=False)
    feat, _, aux = sharded_optimize_map(
        mesh, dec, st.feat, None, trainable_mask(dec, inp["cfg"]),
        _t(inp["feat_mask"]), st.pos, st.grid, _t(inp["kc"]), _t(inp["kd"]),
        _t(inp["kp"]), ReplayDraws(inp["draws"][mesh.rank], "cpu"),
        inp["n_geo"], inp["n_col"], inp["lrs_geo"], inp["lrs_col"],
        MapperOptions(**inp["mopts"]), RenderOptions(**inp["ropts"]),
        inp["ppf"])
    return {"feat": _np(feat),
            "dec": {k: _np(p) for k, p in dec.named_parameters()},
            "aux": [float(a) for a in aux]}


def collectives(mesh):
    """psum, pmax, ring shifts both ways, all_gather_rows of unequal row
    counts and a broadcast, on small known tensors."""
    r, n = mesh.rank, mesh.size()
    s = mesh.psum({"a": torch.full((3,), float(r + 1)),
                   "b": torch.tensor([r], dtype=torch.int32)})
    return {"psum": _np(s["a"]), "psum_int": _np(s["b"]),
            "pmax": int(mesh.pmax(torch.tensor([r], dtype=torch.int32))),
            "fwd": [_np(t) for t in mesh.ring_shift(
                [torch.arange(4.0) + 10 * r,
                 torch.tensor([r], dtype=torch.int32)], 1)],
            "back": _np(mesh.ring_shift([torch.arange(2.0) + r], -1)[0]),
            "rows": _np(mesh.all_gather_rows(torch.full((r + 1, 2),
                                                        float(r)))),
            "bcast": mesh.broadcast_from_rank0({"from": r})}


def ray_dp_helpers(mesh):
    """sharded_train_step and sharded_render on the dry run's tiny scene:
    the step's loss, its features' move and the frozen color embedder;
    the gathered render against this rank's own plain render of its block
    with the same draws, and every rank's block."""
    import copy

    from loopy_slam_torch.models.decoder import trainable_mask
    from loopy_slam_torch.models.renderer import render_batch_ray
    from loopy_slam_torch.ops.camera import get_rays
    from loopy_slam_torch.ops.draws import TorchDraws
    from loopy_slam_torch.parallel import dryrun
    from loopy_slam_torch.parallel.sharded import (sharded_render,
                                                   sharded_train_step)

    torch.set_flush_denormal(True)
    cfg = dryrun.tiny_cfg()
    ds, state, dec, mopts, c2w = dryrun.build_scene(cfg, "cpu")
    _, color, depth, _ = ds[0]
    ropts = RenderOptions.from_cfg(cfg)
    B0 = dec.col.B.detach().clone()
    feat, _, loss = sharded_train_step(
        mesh, dec, state.feat.clone(), None, trainable_mask(dec, cfg),
        torch.arange(state.pos.shape[0]) < state.count, state.pos,
        state.grid, _t(color)[None], _t(depth)[None],
        _t(np.asarray(c2w)[None, :3]), TorchDraws(50 + mesh.rank, "cpu"),
        [0.005] * 3, mopts, ropts, 32)
    c = cfg["cam"]
    ro, rd = get_rays(c["H"], c["W"], c["fx"], c["fy"], c["cx"], c["cy"],
                      _t(c2w))
    ro, rd, gd = ro.reshape(-1, 3), rd.reshape(-1, 3), _t(depth).reshape(-1)
    out = sharded_render(mesh, dec, state.pos, state.grid, state.feat, ro,
                         rd, gd, TorchDraws(70 + mesh.rank, "cpu"), ropts)
    R, n, r = ro.shape[0], mesh.size(), mesh.rank
    lo, hi = R * r // n, R * (r + 1) // n
    own = render_batch_ray(dec, state.pos, state.grid, state.feat, ro[lo:hi],
                           rd[lo:hi], gd[lo:hi], gd[lo:hi] > 0,
                           TorchDraws(70 + r, "cpu"), ropts, "color")
    return {"loss": float(loss),
            "moved": float((feat - state.feat).abs().max()),
            "B_kept": bool(torch.equal(dec.col.B, B0)),
            "render": [_np(t) for t in out], "own": [_np(t) for t in own],
            "block": (lo, hi), "rays": R}


def raise_on_rank1(mesh):
    """Rank 1 raises before the collective rank 0 waits in."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.psum([torch.ones(1)])
    return "unreachable"
