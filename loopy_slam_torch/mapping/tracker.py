"""Camera tracking: the per-frame pose-optimization loop.

Port of loopy_slam_tpu/mapping/tracker.py. Each iteration samples pixels,
renders, computes the tracking loss, and takes a functional Adam step on
the pose 7-vector; the candidate kept is the post-step pose whose pre-step
loss was minimal. With knn_refresh > 0 the k-NN and neighbour gather run
once per block over a pool of pool_factor*pixels rays (the reference's
cached path), in warm-up blocks of 2, 4, 8, ... iterations capped at
knn_refresh. The loop never reads a device value on the host.

  inside gate:  gt_depth <= min(10*median, 1.2*max)
  dynamic gate: |gt-d|/sqrt(var) < 10*mean (handle_dynamic)
  geo loss:     sum clamp(|gt-d|/sqrt(var+1e-10), 0, 1e3)
  color loss:   sum |gt_c - c|; total = geo + w_color*color
Separate LRs: translation lr, quaternion lr*0.2. With
model.encode_exposure the frame's exposure latent (8) and the exposure MLP
train beside the pose, each at lr 0.001, and the renders go through their
affine; their final values come back for the session to keep.

Random draws (ops/draws.py), in order. Cached path, per block: the pool's
pixel rows (P,) then cols (P,) -- or, with a pre-selected pixel pool (the
color-gradient picks), one index into it (P,); per iteration: the pool
pick (pixels,), then the decode's geometry and color noise (pixels*S, c)
each (where models/track_render renders the iteration, both before it).
Uncached path, per iteration: rows (pixels,) and cols (pixels,), or one
index into the pre-selected pool (pixels,); then the decode noise.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from ..models import track_render
from ..models.decoder import ExposureMLP
from ..models.renderer import (RenderOptions, decode_neighbors,
                               gather_featpos, render_batch_ray)
from ..ops import adam, knn
from ..ops.camera import c2w_from_tensor, c2w_to_4x4, rays_from_uv
from ..ops.compositing import composite
from ..ops.masked import masked_mean, masked_median
from ..ops.sampling import (inside_mask_from_depth, sample_pixels,
                            surface_z_vals)
from ..utils import telemetry


class TrackOptions(NamedTuple):
    """Static tracking configuration."""

    pixels: int = 200
    iters: int = 20
    lr: float = 0.002
    separate_LR: bool = True
    w_color_loss: float = 0.5
    use_color_in_tracking: bool = True
    handle_dynamic: bool = True
    depth_limit: bool = False
    ignore_edge_W: int = 20
    ignore_edge_H: int = 20
    H: int = 680
    W: int = 1200
    fx: float = 600.0
    fy: float = 600.0
    cx: float = 599.5
    cy: float = 339.5
    knn_refresh: int = 10
    pool_factor: int = 4
    health_gate: float = 0.0
    health_freeze: float = 1.5
    health_streak: int = 10

    @staticmethod
    def from_cfg(cfg):
        t = cfg["tracking"]
        cam = cfg["cam"]
        e = cam["crop_edge"] or 0
        return TrackOptions(
            pixels=t["pixels"], iters=t["iters"], lr=t["lr"],
            separate_LR=t["separate_LR"], w_color_loss=t["w_color_loss"],
            use_color_in_tracking=t["use_color_in_tracking"],
            handle_dynamic=t["handle_dynamic"], depth_limit=t["depth_limit"],
            ignore_edge_W=t["ignore_edge_W"], ignore_edge_H=t["ignore_edge_H"],
            H=cam["H"] - 2 * e, W=cam["W"] - 2 * e,
            fx=cam["fx"], fy=cam["fy"],
            cx=cam["cx"] - e, cy=cam["cy"] - e,
            knn_refresh=int(t.get("knn_refresh", 10)),
            pool_factor=max(1, int(t.get("pool_factor", 4))),
            health_gate=float(t.get("health_gate_factor", 0.0)),
            health_freeze=float(t.get("health_ema_freeze", 1.5)),
            health_streak=int(t.get("health_reject_streak", 10)),
        )


def _lr_vector(opts: TrackOptions, device) -> torch.Tensor:
    if opts.separate_LR:
        v = [opts.lr * 0.2] * 4 + [opts.lr] * 3
    else:
        v = [opts.lr] * 7
    return torch.tensor(v, dtype=torch.float32, device=device)


def _loss_from_render(d, c, inside, depth, var, color, opts: TrackOptions):
    var = var.detach()
    nan_mask = torch.isfinite(depth) & torch.isfinite(var)
    tmp = torch.abs(d - depth) / torch.sqrt(var + 1e-10)
    if opts.handle_dynamic:
        gate = tmp < 10.0 * masked_mean(tmp, inside)
    else:
        gate = torch.abs(d - depth) < 10.0 * masked_median(
            torch.abs(d - depth), inside)
    mask = gate & (d > 0) & nan_mask & inside
    zero = torch.zeros((), device=d.device)
    geo = torch.sum(torch.where(mask, torch.clamp(tmp, 0.0, 1e3), zero))
    col = torch.sum(torch.where(mask[:, None], torch.abs(c - color), zero))
    loss = geo + (opts.w_color_loss * col if opts.use_color_in_tracking
                  else 0.0)
    return loss, (geo, col, torch.sum(mask))


def _pick_pixels(draw, n, gt_color, gt_depth, sel_i, sel_j,
                 opts: TrackOptions):
    """n pixels drawn uniformly from the pre-selected pool (sel_i cols,
    sel_j rows: the color-gradient picks), or from the frame inside the
    ignored edges without a pool. Returns float (i, j) and their depth,
    color and validity (depth > 0, and < 5 m with depth_limit)."""
    if sel_i is not None:
        pick = draw.randint((n,), 0, sel_i.shape[0])
        ii, jj = sel_i[pick].long(), sel_j[pick].long()
        i, j = ii.float(), jj.float()
        d, c = gt_depth[jj, ii], gt_color[jj, ii]
    else:
        i, j, d, c = sample_pixels(
            draw, opts.ignore_edge_H, opts.H - opts.ignore_edge_H,
            opts.ignore_edge_W, opts.W - opts.ignore_edge_W, n, gt_depth,
            gt_color)
    valid = d > 0
    if opts.depth_limit:
        valid = valid & (d < 5.0)
    return i, j, d, c, valid


def tracking_loss(cam7, dec, map_pos, grid, feats, gt_color, gt_depth, draw,
                  opts: TrackOptions, ropts: RenderOptions, sel_i=None,
                  sel_j=None, r_query=None, exposure=None, eval_fn=None):
    """Sample pixels (from the pool sel_i/sel_j if given), render at pose
    cam7 with the (H, W) query-radius map r_query if given, compute the
    tracking loss. exposure: (latent, ExposureMLP) with encode_exposure,
    else None; eval_fn: see render_batch_ray."""
    c2w = c2w_from_tensor(cam7)
    i, j, d, c, valid = _pick_pixels(draw, opts.pixels, gt_color, gt_depth,
                                     sel_i, sel_j, opts)
    rays_o, rays_d = rays_from_uv(i, j, c2w, opts.fx, opts.fy, opts.cx,
                                  opts.cy)
    rq = None if r_query is None else r_query[j.long(), i.long()]
    inside = inside_mask_from_depth(d, valid) & valid
    ef, mlp = exposure if exposure is not None else (None, None)
    depth, var, color, _ = render_batch_ray(
        dec, map_pos, grid, feats, rays_o, rays_d, d, inside, draw, ropts,
        "color", r_query=rq, exposure_feat=ef, exposure_mlp=mlp,
        eval_fn=eval_fn)
    return _loss_from_render(d, c, inside, depth, var, color, opts)


def _build_track_cache(cam7, map_pos, grid, feats, gt_color, gt_depth, draw,
                       opts: TrackOptions, ropts: RenderOptions, sel_i=None,
                       sel_j=None, r_query=None):
    """Per-block tracking pool: pool_factor*pixels rays with z-vals,
    neighbour distances/counts and gathered [features || position] rows,
    computed once at the block-start pose (and the rays' query radii when
    r_query is given)."""
    P = opts.pixels * opts.pool_factor
    c2w = c2w_from_tensor(cam7)
    i, j, d, c, valid = _pick_pixels(draw, P, gt_color, gt_depth, sel_i,
                                     sel_j, opts)
    rq = None if r_query is None else r_query[j.long(), i.long()]
    inside = inside_mask_from_depth(d, valid) & valid
    S = ropts.n_surface
    z = surface_z_vals(d, inside, S, ropts.near_end_surface,
                       ropts.far_end_surface, ropts.near_end)
    rays_o, rays_d = rays_from_uv(i, j, c2w, opts.fx, opts.fy,
                                  opts.cx, opts.cy)
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
           ).reshape(-1, 3)
    rq_s = (ropts.radius_query if rq is None
            else torch.repeat_interleave(rq, S))
    D, I, nn = knn.query_chunked(grid, map_pos, pts.detach(), ropts.nn_num,
                                 rq_s)
    both = gather_featpos(feats, map_pos, I)
    k = ropts.nn_num
    return {"i": i, "j": j, "d": d, "c": c, "inside": inside, "z": z,
            "rq": rq, "D": D.reshape(P, S * k),
            "both": both.reshape(P, S * k, -1), "nn": nn.reshape(P, S)}


def tracking_loss_cached(cam7, dec, cache, draw, opts: TrackOptions,
                         ropts: RenderOptions, exposure=None):
    """tracking_loss with the k-NN + gather served from the block pool: a
    fresh `pixels` subset per iteration, pose-dependent terms recomputed.
    Where track_render.eligible holds, the decode and compositing are one
    track_render.render call (two kernels on the card), with both noise
    draws made before it; otherwise decode_neighbors and composite."""
    c2w = c2w_from_tensor(cam7)
    S, k = ropts.n_surface, ropts.nn_num
    R = opts.pixels
    P = cache["d"].shape[0]
    pick = draw.randint((R,), 0, P)

    def take(a):
        return a.index_select(0, pick)

    d, c, inside, z = (take(cache["d"]), take(cache["c"]),
                       take(cache["inside"]), take(cache["z"]))
    rays_o, rays_d = rays_from_uv(take(cache["i"]), take(cache["j"]), c2w,
                                  opts.fx, opts.fy, opts.cx, opts.cy)
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
           ).reshape(-1, 3)
    if track_render.eligible(ropts, exposure):
        noise_geo = draw.normal((R * S, ropts.c_dim))
        noise_col = draw.normal((R * S, ropts.c_dim))
        depth, var, color = track_render.render(
            dec, pts, z, cache, pick, noise_geo, noise_col, ropts)
    else:
        D_idx = take(cache["D"]).reshape(R * S, k)
        both = take(cache["both"]).reshape(R * S, k, -1)
        nn = take(cache["nn"]).reshape(R * S)
        views_d = (torch.repeat_interleave(rays_d, S, dim=0)
                   if ropts.use_view_direction else None)
        rq = (ropts.radius_query if cache["rq"] is None
              else torch.repeat_interleave(take(cache["rq"]), S))
        ef, mlp = exposure if exposure is not None else (None, None)
        occ, rgb, _has = decode_neighbors(
            dec, pts, draw, ropts, "color", D_idx, both, nn, rq,
            views_d=views_d, exposure_feat=ef, exposure_mlp=mlp)
        depth, var, color, _ = composite(
            rgb.reshape(R, S, 3), occ.reshape(R, S), z, ropts.sigmoid_coef)
    depth = torch.where(d > 0, depth, torch.zeros((), device=d.device))
    return _loss_from_render(d, c, inside, depth, var, color, opts)


def _apply_health_gate(health, best_loss, best_nm, cam7_init, best_cam,
                       opts: TrackOptions, total_px: float):
    """Accept or reject the optimized pose and update the gate state
    [loss EMA, total rejects, consecutive-reject streak]. Rejects (keeps
    the motion-model pose) on per-masked-pixel loss above health_gate x
    the healthy EMA, or on mask-support collapse (< 5% of rays); after
    health_streak consecutive loss-rejects with healthy support, accepts
    and re-seeds the EMA. The EMA only follows frames within
    health_freeze x of itself. Returns (out_cam7, health')."""
    ema, nrej, streak = health[0], health[1], health[2]
    best_nm = best_nm.float()
    mean_best = best_loss / torch.clamp(best_nm, min=1.0)
    bad_loss = (ema > 0) & (mean_best > opts.health_gate * ema)
    bad_support = best_nm < 0.05 * total_px
    unhealthy = (opts.health_gate > 0) & (bad_loss | bad_support)
    escape = (opts.health_streak > 0) & unhealthy & ~bad_support \
        & (streak >= opts.health_streak - 1)
    unhealthy = unhealthy & ~escape
    streak_reject = unhealthy & ~bad_support
    out_cam = torch.where(unhealthy, cam7_init, best_cam)
    healthy_update = mean_best <= opts.health_freeze * ema
    ema_new = torch.where(
        unhealthy, ema,
        torch.where(escape, mean_best,
                    torch.where(ema > 0,
                                torch.where(healthy_update,
                                            0.95 * ema + 0.05 * mean_best,
                                            ema),
                                mean_best)))
    streak_new = torch.where(streak_reject, streak + 1.0,
                             torch.zeros((), device=streak.device))
    health_out = torch.stack([ema_new, nrej + unhealthy.float(), streak_new])
    return out_cam, health_out


def warmup_blocks(iters: int, refresh: int) -> List[int]:
    """Block lengths 2, 4, 8, ... capped at refresh, summing to iters."""
    lengths, left, blk_len = [], iters, 2
    while left > 0:
        take_n = min(blk_len, refresh, left)
        lengths.append(take_n)
        left -= take_n
        blk_len *= 2
    return lengths


class TrackResult(NamedTuple):
    """track_frame's outputs, device tensors: the accepted pose 7-vector
    and 4x4, the first and best loss, the health gate's state, and with
    encode_exposure the final exposure latent and MLP (else None)."""

    cam7: torch.Tensor
    c2w44: torch.Tensor
    first_loss: torch.Tensor
    best_loss: torch.Tensor
    health: torch.Tensor
    exposure_feat: Optional[torch.Tensor] = None
    exposure_mlp: Optional[ExposureMLP] = None


def _track_frame_impl(dec, map_pos, grid, feats, gt_color, gt_depth,
                      cam7_init, draw, opts: TrackOptions,
                      ropts: RenderOptions, health=None, sel_i=None,
                      sel_j=None, r_query=None, exposure_feat=None,
                      mesh=None, eval_fn_builder=None) -> TrackResult:
    """Optimize the camera pose (and with ropts.encode_exposure the
    exposure latent, from exposure_feat or zeros, and the exposure MLP,
    from dec.col.exposure) for one frame. sel_i/sel_j: a pool of
    pre-selected pixels (cols, rows; the color-gradient picks) to draw
    from instead of the whole frame; r_query: the frame's (H, W) query
    radius map (the dynamic radius).

    Multi-device (parallel/): with a mesh, every rank renders its own
    opts.pixels rays from its own `draw`, and the loss, its mask count and
    the gradients are summed over the ranks every iteration, so every rank
    takes the same step; eval_fn_builder(dec, feats) -> eval_fn replaces
    the sample decode (the map-sharded ring k-NN; no k-NN cache then)."""
    dev = cam7_init.device
    lr_cam = _lr_vector(opts, dev)
    cam = cam7_init.detach().clone()
    # the optimized variables: the pose, then the exposure latent and MLP
    extra: List[torch.Tensor] = []
    if ropts.encode_exposure:
        e = dec.col.exposure
        ef = (torch.zeros(e.w1.shape[0], device=dev) if exposure_feat is None
              else exposure_feat)
        extra = [t.detach().clone() for t in (ef, e.w1, e.b1, e.w2, e.b2)]
    lrs = [lr_cam] + [0.001] * len(extra)
    st = adam.init([cam] + extra)
    best_loss = torch.full((), float("inf"), device=dev)
    best_cam = cam7_init.detach().clone()
    best_nm = torch.zeros((), device=dev)
    first_loss = torch.zeros((), device=dev)
    use_cache = (opts.knn_refresh > 0 and not ropts.sample_near_pcl
                 and eval_fn_builder is None)
    feats = feats.detach()
    eval_fn = (None if eval_fn_builder is None
               else eval_fn_builder(dec, feats))

    tr = telemetry.current()

    def step(loss_fn):
        nonlocal cam, extra, st, best_loss, best_cam, best_nm
        vs = [v.requires_grad_(True) for v in [cam] + extra]
        exposure = ((vs[1], ExposureMLP(*vs[2:])) if extra else None)
        fused = int(use_cache and track_render.eligible(ropts, exposure))
        with tr.span("track.fwd", fused=fused):
            loss, aux = loss_fn(vs[0], exposure)
        with tr.span("track.bwd"):
            grads = torch.autograd.grad(loss, vs)
        loss = loss.detach()
        if mesh is not None:
            *grads, loss, n_mask = mesh.psum(
                list(grads) + [loss, aux[2].float()])
            aux = (aux[0], aux[1], n_mask)
        with tr.span("track.adam"):
            new, st = adam.update([v.detach() for v in vs], grads, st, lrs)
        cam, extra = new[0], new[1:]
        better = loss < best_loss
        best_loss = torch.where(better, loss, best_loss)
        best_cam = torch.where(better, cam, best_cam)
        best_nm = torch.where(better, aux[2].float(), best_nm)
        return loss

    n_done = 0
    if use_cache:
        for blk_len in warmup_blocks(opts.iters, opts.knn_refresh):
            with torch.no_grad(), tr.span("track.pool", size=blk_len):
                cache = _build_track_cache(
                    cam, map_pos, grid, feats, gt_color, gt_depth, draw,
                    opts, ropts, sel_i, sel_j, r_query)
            for _ in range(blk_len):
                with tr.span("track.iter", it=n_done):
                    loss = step(lambda c7, ex: tracking_loss_cached(
                        c7, dec, cache, draw, opts, ropts, ex))
                if n_done == 0:
                    first_loss = loss
                n_done += 1
    else:
        for _ in range(opts.iters):
            with tr.span("track.iter", it=n_done):
                loss = step(lambda c7, ex: tracking_loss(
                    c7, dec, map_pos, grid, feats, gt_color, gt_depth, draw,
                    opts, ropts, sel_i, sel_j, r_query, ex, eval_fn))
            if n_done == 0:
                first_loss = loss
            n_done += 1

    out_cam = best_cam
    if health is None:
        health_out = torch.zeros(3, device=dev)
    else:
        with tr.span("track.gate"):
            out_cam, health_out = _apply_health_gate(
                health, best_loss, best_nm, cam7_init, best_cam, opts,
                total_px=float(opts.pixels
                               * (1 if mesh is None else mesh.size())))
    with torch.no_grad():
        best_c2w44 = c2w_to_4x4(c2w_from_tensor(out_cam))
    return TrackResult(out_cam, best_c2w44, first_loss, best_loss,
                       health_out, extra[0] if extra else None,
                       ExposureMLP(*extra[1:]) if extra else None)


track_frame = _track_frame_impl
