"""Mapping: point insertion, frustum feature selection, and the two-stage
(geometry -> color) map optimization.

Port of loopy_slam_tpu/mapping/mapper.py for one device. Each iteration
optimizes the decoders and the FULL feature buffer with gradients masked
by the frustum-selection mask and the decoders' trainable mask; the Adam
state threads across chunks; the session starts the color leaves afresh
at the color stage (stage_chunks, start_color_stage: unlike the JAX
package, which threads one step count through both stages). With
pixel_pool_factor > 0 each chunk samples a pool of rays once, runs the
k-NN once over it, and every iteration draws its rays from the pool.

Loss: depth L1 over (gt>0 & valid_ray & finite & inside) rays; the color
stage adds w_color_loss * color L1 against targets clipped to
[1/510, 1 - 1/510]. With model.encode_exposure the renderer hands back raw
color logits and each window frame's composited colors go through its own
exposure affine (the keyframes' stored latents, the current frame's
trainable one at lr 0.001), then the soft clamp and the sigmoid.

Random draws (ops/draws.py), in order. Insertion: rows (n,), cols (n,),
then the new features' normals; insertion at given pixels (the
color-gradient picks): the normals only. A pooled chunk: the pool's rows (F, P)
and cols (F, P); then per iteration the picks (F, pix_per_frame) and the
decode's noise (geometry, then color in the color stage). Unpooled
iteration: rows (F, pix) and cols (F, pix), then the decode's noise.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..models.decoder import exposure_affine
from ..models.renderer import (RenderOptions, decode_neighbors,
                               gather_featpos, render_batch_ray,
                               soft_clamp_logits)
from ..ops import adam, knn
from ..ops.camera import invert_c2w, project_points, rays_from_uv
from ..ops.compositing import composite
from ..ops.image import bilinear_sample
from ..ops.masked import masked_max, masked_median
from ..ops.sampling import sample_rays, surface_z_vals
from .point_cloud import MapOptions, MapState, add_points


class MapperOptions(NamedTuple):
    """Static mapping configuration."""

    pixels: int = 1000
    w_color_loss: float = 0.1
    frustum_edge: int = -4
    frustum_feature_selection: bool = True
    H: int = 680
    W: int = 1200
    fx: float = 600.0
    fy: float = 600.0
    cx: float = 599.5
    cy: float = 339.5
    pixel_pool_factor: int = 8
    pool_color_stage: bool = True
    encode_exposure: bool = False

    @staticmethod
    def from_cfg(cfg):
        m = cfg["mapping"]
        cam = cfg["cam"]
        e = cam["crop_edge"] or 0
        return MapperOptions(
            pixels=m["pixels"], w_color_loss=m["w_color_loss"],
            frustum_edge=m["frustum_edge"],
            frustum_feature_selection=m["frustum_feature_selection"],
            H=cam["H"] - 2 * e, W=cam["W"] - 2 * e,
            fx=cam["fx"], fy=cam["fy"], cx=cam["cx"] - e, cy=cam["cy"] - e,
            pixel_pool_factor=int(m.get("pixel_pool_factor", 8)),
            pool_color_stage=bool(m.get("pool_color_stage", True)),
            encode_exposure=cfg["model"]["encode_exposure"],
        )


# ---------------------------------------------------------------------------
# Point insertion
# ---------------------------------------------------------------------------

def sample_insert_candidates(draw, gt_color, gt_depth, cur_c2w, prev_c2w,
                             opts: MapperOptions, n_rays: int,
                             overlap: Optional[bool] = None,
                             dynamic_r_add=None):
    """Sample n_rays pixels and apply the previous-frustum overlap split.
    Returns (rays_o, rays_d, d, c, valid, dra): dra is the (H, W) map
    dynamic_r_add at the picked pixels, or None."""
    rays_o, rays_d, d, c, valid, ii, jj = sample_rays(
        draw, 0, opts.H, 0, opts.W, n_rays, cur_c2w, gt_depth, gt_color,
        opts.fx, opts.fy, opts.cx, opts.cy)
    if overlap is not None:
        pts = rays_o + rays_d * d[:, None]
        uv, _ = project_points(pts, invert_c2w(prev_c2w),
                               opts.fx, opts.fy, opts.cx, opts.cy)
        inside = ((uv[:, 0] > 0) & (uv[:, 0] < opts.W)
                  & (uv[:, 1] > 0) & (uv[:, 1] < opts.H))
        valid = valid & (inside if overlap else ~inside)
    dra = None if dynamic_r_add is None else dynamic_r_add[jj, ii]
    return rays_o, rays_d, d, c, valid, dra


@torch.no_grad()
def add_points_from_frame(state: MapState, gt_color, gt_depth, cur_c2w,
                          prev_c2w, draw, mopts: MapOptions,
                          opts: MapperOptions, n_rays: int,
                          overlap: Optional[bool] = None,
                          dynamic_r_add=None):
    """Sample n_rays pixels of the current frame and insert surface points.
    overlap=None: no frustum split (frame 0); False: keep only points
    OUTSIDE the previous mapped frame's frustum; True: only INSIDE it.
    dynamic_r_add: the frame's (H, W) add-radius map, or None."""
    rays_o, rays_d, d, c, valid, dra = sample_insert_candidates(
        draw, gt_color, gt_depth, cur_c2w, prev_c2w, opts, n_rays, overlap,
        dynamic_r_add)
    return add_points(state, mopts, draw, rays_o, rays_d, d, c, valid,
                      dynamic_r_add=dra)


def pixel_insert_candidates(flat_idx, gt_color, gt_depth, cur_c2w,
                            opts: MapperOptions, dynamic_r_add=None):
    """Candidate tuple (rays_o, rays_d, d, c, valid, dra) of pre-selected
    pixels, given as flat row-major indices (the color-gradient picks);
    dra is the (H, W) map dynamic_r_add at those pixels, or None."""
    jj = torch.div(flat_idx, opts.W, rounding_mode="floor").long()
    ii = (flat_idx % opts.W).long()
    rays_o, rays_d = rays_from_uv(ii.float(), jj.float(), cur_c2w,
                                  opts.fx, opts.fy, opts.cx, opts.cy)
    d = gt_depth[jj, ii]
    dra = None if dynamic_r_add is None else dynamic_r_add[jj, ii]
    return rays_o, rays_d, d, gt_color[jj, ii], d > 0, dra


@torch.no_grad()
def add_points_at_pixels(state: MapState, gt_color, gt_depth, cur_c2w,
                         flat_idx, draw, mopts: MapOptions,
                         opts: MapperOptions, dynamic_r_add=None):
    """Insert points at pre-selected pixels (the color-gradient picks),
    gated by radius_min or the frame's dynamic add-radius map. Draws: the
    new features' normals only."""
    rays_o, rays_d, d, c, valid, dra = pixel_insert_candidates(
        flat_idx, gt_color, gt_depth, cur_c2w, opts, dynamic_r_add)
    return add_points(state, mopts, draw, rays_o, rays_d, d, c, valid,
                      dynamic_r_add=dra, is_pts_grad=True)


@torch.no_grad()
def frustum_feature_mask(map_pos, count, cur_c2w, gt_depth,
                         opts: MapperOptions):
    """Which buffer points are optimizable this mapping frame: inside the
    image widened by -frustum_edge px, and 0 <= depth along the axis <=
    bilinear-sampled depth (zero taps -> max depth) + 0.5."""
    uv, z = project_points(map_pos, invert_c2w(cur_c2w),
                           opts.fx, opts.fy, opts.cx, opts.cy)
    e = opts.frustum_edge
    inb = ((uv[:, 0] < opts.W - e) & (uv[:, 0] > e)
           & (uv[:, 1] < opts.H - e) & (uv[:, 1] > e))
    d = bilinear_sample(gt_depth, uv[:, 0], uv[:, 1])
    d = torch.where(d == 0, torch.max(d), d)
    mask = inb & (0 <= -z) & (-z <= d + 0.5)
    return mask & (torch.arange(map_pos.shape[0], device=map_pos.device)
                   < count)


# ---------------------------------------------------------------------------
# The optimization loop
# ---------------------------------------------------------------------------

def _window_rays(draw, kf_color, kf_depth, kf_c2w, kf_rq,
                 opts: MapperOptions, n: int):
    """n rays per window frame: (ro, rd, d, c, valid, rq), each
    (F, n, ...); rq is the per-ray query radius read from the frames'
    (F, H, W) maps kf_rq, or None without them."""
    F = kf_color.shape[0]
    j = draw.randint((F, n), 0, opts.H)
    i = draw.randint((F, n), 0, opts.W)
    f = torch.arange(F, device=kf_color.device)[:, None]
    d = kf_depth[f, j, i]
    c = kf_color[f, j, i]
    rq = None if kf_rq is None else kf_rq[f, j, i]
    ro, rd = rays_from_uv(i.float(), j.float(), kf_c2w, opts.fx, opts.fy,
                          opts.cx, opts.cy)
    return ro, rd, d, c, d > 0, rq


def _exposed(color, dec, exposure, F: int):
    """Each window frame's composited color logits (F * n, 3) through its
    exposure affine, soft clamp and sigmoid. exposure: (kf_exposure (F, 8)
    of which the last row is replaced, exp (8,) the current frame's
    trainable latent)."""
    kf_exposure, exp = exposure
    latents = torch.cat([kf_exposure[:-1], exp[None]])
    rots, transs = exposure_affine(dec.col.exposure, latents)
    cf = torch.einsum("fpc,fcd->fpd", color.reshape(F, -1, 3), rots) \
        + transs[:, None, :]
    return torch.sigmoid(soft_clamp_logits(cf)).reshape(-1, 3)


def _loss_terms(d, c, inside, valid_ray, depth, color, stage,
                opts: MapperOptions, dec=None, exposure=None, F: int = 1):
    if stage == "color" and opts.encode_exposure:
        color = _exposed(color, dec, exposure, F)
    m = (d > 0) & valid_ray & torch.isfinite(depth) & inside
    zero = torch.zeros((), device=d.device)
    geo_loss = torch.sum(torch.where(m, torch.abs(d - depth), zero))
    loss = geo_loss
    col_loss = zero
    if stage == "color":
        c = torch.clamp(c, 1.0 / 510.0, 1.0 - 1.0 / 510.0)
        col_loss = torch.sum(torch.where(m[:, None], torch.abs(c - color),
                                         zero))
        loss = loss + opts.w_color_loss * col_loss
    return loss, (geo_loss.detach(), col_loss.detach(),
                  torch.sum(m).float())


def _map_loss(dec, feats, map_pos, grid, kf_color, kf_depth, kf_c2w, kf_rq,
              draw, stage, opts: MapperOptions, ropts: RenderOptions,
              pix_per_frame: int, exposure=None):
    """One mapping iteration's loss over pix_per_frame fresh rays from each
    of the F window frames (last = current frame); exposure: see
    _exposed (with encode_exposure)."""
    ro, rd, d, c, valid, rq = _window_rays(draw, kf_color, kf_depth, kf_c2w,
                                           kf_rq, opts, pix_per_frame)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    d, valid, c = d.reshape(-1), valid.reshape(-1), c.reshape(-1, 3)
    med = masked_median(d, valid)
    mx = masked_max(d, valid, fill=0.0)
    inside = valid & (d <= torch.minimum(10.0 * med, 1.2 * mx))
    depth, _var, color, valid_ray = render_batch_ray(
        dec, map_pos, grid, feats, ro, rd, d, inside, draw, ropts, stage,
        r_query=None if rq is None else rq.reshape(-1))
    return _loss_terms(d, c, inside, valid_ray, depth, color, stage, opts,
                       dec, exposure, kf_color.shape[0])


class _NeighborPool(NamedTuple):
    """Per-chunk ray pool with its k-NN done; leading axes (F, P)."""

    pts: torch.Tensor     # (F, P, S, 3) sample positions
    z_vals: torch.Tensor  # (F, P, S)
    d: torch.Tensor       # (F, P) gt depth
    c: torch.Tensor       # (F, P, 3) gt color
    valid: torch.Tensor   # (F, P) bool
    rd: torch.Tensor      # (F, P, 3) ray directions
    rq: Optional[torch.Tensor]  # (F, P) per-ray query radius, or None
    D: torch.Tensor       # (F, P, S*k) index distances
    I: torch.Tensor       # (F, P, S*k) int32 neighbor ids
    nn: torch.Tensor      # (F, P, S) int32 in-radius counts


@torch.no_grad()
def _build_pool(map_pos, grid, kf_color, kf_depth, kf_c2w, kf_rq, draw,
                opts: MapperOptions, ropts: RenderOptions,
                P: int) -> _NeighborPool:
    """Sample the ray pool and run the k-NN once over all its samples (one
    kernel launch on the card), with the per-ray radii of kf_rq if given."""
    F = kf_color.shape[0]
    S, k = ropts.n_surface, ropts.nn_num
    ro, rd, d, c, valid, rq = _window_rays(draw, kf_color, kf_depth, kf_c2w,
                                           kf_rq, opts, P)
    dn = d.reshape(-1)
    vn = valid.reshape(-1)
    med = masked_median(dn, vn)
    mx = masked_max(dn, vn, fill=0.0)
    inside = vn & (dn <= torch.minimum(10.0 * med, 1.2 * mx))
    z = surface_z_vals(dn, inside, S, ropts.near_end_surface,
                       ropts.far_end_surface,
                       ropts.near_end).reshape(F, P, S)
    pts = ro[..., None, :] + rd[..., None, :] * z[..., None]
    N = F * P * S
    rq_s = (ropts.radius_query if rq is None
            else torch.repeat_interleave(rq.reshape(-1), S))
    D, I, nn = knn.query_chunked(grid, map_pos, pts.reshape(N, 3), k, rq_s)
    return _NeighborPool(pts=pts, z_vals=z, d=d, c=c, valid=valid, rd=rd,
                         rq=rq, D=D.reshape(F, P, S * k),
                         I=I.reshape(F, P, S * k), nn=nn.reshape(F, P, S))


def _map_loss_pool(dec, feats, pool: _NeighborPool, map_pos, draw, stage,
                   opts: MapperOptions, ropts: RenderOptions,
                   pix_per_frame: int, exposure=None):
    """One mapping iteration's loss over rays drawn from the pool."""
    F, P = pool.d.shape
    S, k = ropts.n_surface, ropts.nn_num
    idx = draw.randint((F, pix_per_frame), 0, P)
    flat = (torch.arange(F, device=idx.device)[:, None] * P + idx).reshape(-1)

    def take(a):
        return a.reshape((F * P,) + a.shape[2:]).index_select(0, flat)

    d = take(pool.d)
    c = take(pool.c)
    valid = take(pool.valid)
    z_vals = take(pool.z_vals)
    pts = take(pool.pts).reshape(-1, 3)
    D_idx = take(pool.D).reshape(-1, k)
    I = take(pool.I).reshape(-1, k)
    nn = take(pool.nn).reshape(-1)
    rq = (ropts.radius_query if pool.rq is None
          else torch.repeat_interleave(take(pool.rq), S))
    views_d = None
    if ropts.use_view_direction:
        views_d = torch.repeat_interleave(take(pool.rd), S, dim=0)

    med = masked_median(d, valid)
    mx = masked_max(d, valid, fill=0.0)
    inside = valid & (d <= torch.minimum(10.0 * med, 1.2 * mx))

    both = gather_featpos(feats, map_pos, I)
    occ, rgb, has_neighbors = decode_neighbors(
        dec, pts, draw, ropts, stage, D_idx, both, nn, rq, views_d=views_d)
    R = F * pix_per_frame
    valid_ray = torch.sum(has_neighbors.reshape(R, S), dim=-1) >= (S // 2 + 1)
    depth, _var, color, _ = composite(
        rgb.reshape(R, S, 3), occ.reshape(R, S), z_vals, ropts.sigmoid_coef)
    depth = torch.where(d > 0, depth, torch.zeros((), device=d.device))
    return _loss_terms(d, c, inside, valid_ray, depth, color, stage, opts,
                       dec, exposure, F)


def _optimize_map_impl(dec, feat, adam_state, dec_mask: Dict[str, bool],
                       feat_mask, map_pos, grid, kf_color, kf_depth, kf_c2w,
                       draw, n_geo_iters: int, n_col_iters: int,
                       lrs_geo, lrs_col, opts: MapperOptions,
                       ropts: RenderOptions, pix_per_frame: int,
                       kf_rq=None, kf_exposure=None, exp=None):
    """Run a chunk of the geometry -> color mapping optimization.

    dec: Decoders (updated in place); feat: (cap, 2c) packed features;
    adam_state: ops.adam.AdamState over [decoder params..., feat] (and exp
    last, with exposure; None to start fresh); dec_mask: {param name:
    trainable}; feat_mask: (cap,) bool frustum-selected rows;
    lrs_geo/lrs_col: [decoders_lr, geometry_lr, color_lr]; kf_rq: the
    window frames' (F, H, W) query-radius maps (the dynamic radius), or
    None for ropts.radius_query. With opts.encode_exposure: kf_exposure
    (F, 8) the window frames' exposure latents (the last row stands for
    the current frame) and exp (8,) the current frame's latent, trained at
    lr 0.001. Returns (feat, adam_state, (geo_loss, col_loss, n_rays)),
    and exp' after them with exposure.
    """
    names = [n for n, _ in dec.named_parameters()]
    params = [p for _, p in dec.named_parameters()]
    dec_on = [dec_mask[n] for n in names]
    fm = feat_mask[:, None].float()
    c = feat.shape[1] // 2
    with_exp = opts.encode_exposure
    if with_exp and (kf_exposure is None or exp is None):
        raise ValueError("model.encode_exposure needs kf_exposure and exp")
    extra = [exp.detach()] if with_exp else []
    if adam_state is None:
        adam_state = adam.init(params + [feat] + extra)
    use_pool = opts.pixel_pool_factor > 0 and not ropts.sample_near_pcl
    pool = None
    if use_pool:
        pool = _build_pool(map_pos, grid, kf_color, kf_depth, kf_c2w, kf_rq,
                           draw, opts, ropts,
                           opts.pixel_pool_factor * pix_per_frame)
    aux = (torch.zeros((), device=feat.device),) * 3
    for stage, n_iters, lrs in (("geometry", n_geo_iters, lrs_geo),
                                ("color", n_col_iters, lrs_col)):
        pool_this_stage = use_pool and (stage != "color"
                                        or opts.pool_color_stage)
        lr_feat = torch.cat([torch.full((c,), float(lrs[1])),
                             torch.full((c,), float(lrs[2]))]).to(feat.device)
        lr_list = [float(lrs[0])] * len(params) + [lr_feat] \
            + [0.001] * len(extra)
        for _ in range(n_iters):
            feat_v = feat.detach().requires_grad_(True)
            exp_v = [e.detach().requires_grad_(True) for e in extra]
            exposure = (kf_exposure, exp_v[0]) if with_exp else None
            if pool_this_stage:
                loss, aux = _map_loss_pool(dec, feat_v, pool, map_pos, draw,
                                           stage, opts, ropts, pix_per_frame,
                                           exposure)
            else:
                loss, aux = _map_loss(dec, feat_v, map_pos, grid, kf_color,
                                      kf_depth, kf_c2w, kf_rq, draw, stage,
                                      opts, ropts, pix_per_frame, exposure)
            grads = torch.autograd.grad(loss, params + [feat_v] + exp_v,
                                        allow_unused=True)
            n = len(params)
            grads = [g if (on and g is not None) else None
                     for g, on in zip(grads[:n], dec_on)] \
                + [grads[n] * fm if grads[n] is not None else None] \
                + list(grads[n + 1:])
            with torch.no_grad():
                new, adam_state = adam.update(
                    [p.detach() for p in params] + [feat_v.detach()]
                    + [e.detach() for e in exp_v], grads, adam_state,
                    lr_list)
                for p, q in zip(params, new[:n]):
                    p.copy_(q)
                feat = new[n]
                extra = new[n + 1:]
    if with_exp:
        return feat, adam_state, aux, extra[0]
    return feat, adam_state, aux


optimize_map = _optimize_map_impl


def stage_chunks(n_geo: int, n_col: int, chunk: int):
    """A mapping frame's budget as optimize_map calls: (geometry iters,
    color iters, first chunk of its stage) for the geometry stage in
    chunks of `chunk`, then the color stage in chunks of `chunk`; no chunk
    holds both stages, so the session can start the color stage's leaves
    afresh between them (start_color_stage)."""
    out = [(min(chunk, n_geo - i), 0, i == 0) for i in range(0, n_geo, chunk)]
    out += [(0, min(chunk, n_col - i), i == 0) for i in range(0, n_col, chunk)]
    return out


def start_color_stage(adam_state, dec, c: int):
    """The geometry stage's Adam state with the color leaves started afresh:
    the color decoder, the color half of the (cap, 2c) features and the
    exposure latent (the leaves after the features). They had no gradient
    in the geometry stage.

    The JAX package threads one state, with one step count, from the
    geometry stage into the color stage. The color leaves' moments are
    zero there, so a step count of ~400 bias-corrects their first ~100
    steps to 2-4x the set learning rate; on Replica's first frame that
    drives the color head into saturation in both packages, which it
    leaves or not by chance (PERF.md, Findings). The original system's
    torch.optim.Adam counts a parameter's steps from its first gradient,
    as this does; the geometry leaves go on."""
    names = [n for n, _ in dec.named_parameters()]
    n_extra = len(adam_state.m) - len(names) - 1
    feat_cols = torch.arange(2 * c, device=adam_state.m[len(names)].device)
    return adam.restart(adam_state, [n.startswith("col.") for n in names]
                        + [feat_cols >= c] + [True] * n_extra)


# ---------------------------------------------------------------------------
# Host-side keyframe overlap selection
# ---------------------------------------------------------------------------

def keyframe_selection_overlap(rng, gt_depth, cur_c2w, kf_c2ws, k,
                               opts: MapperOptions, n_samples=8, pixels=200
                               ) -> List[int]:
    """Score keyframes by frustum overlap with the current view and pick k
    at random among the >0 scorers. Pure numpy (poses + a sparse depth
    sample), drawing from the numpy Generator `rng`."""
    H, W = gt_depth.shape
    rs = rng
    j = rs.integers(0, H, size=pixels)
    i = rs.integers(0, W, size=pixels)
    d = gt_depth[j, i]
    keep = d > 0
    i, j, d = i[keep], j[keep], d[keep]
    if d.size == 0 or len(kf_c2ws) == 0:
        return []
    dirs = np.stack([(i - opts.cx) / opts.fx,
                     -(j - opts.cy) / opts.fy,
                     -np.ones_like(d)], -1)
    rays_d = dirs @ np.asarray(cur_c2w)[:3, :3].T
    rays_o = np.asarray(cur_c2w)[:3, 3]
    t = np.linspace(0.0, 1.0, n_samples)
    near = (d * 0.8)[:, None]
    far = (d + 0.5)[:, None]
    z_vals = near * (1 - t) + far * t
    pts = (rays_o + rays_d[:, None, :] * z_vals[..., None]).reshape(-1, 3)
    K = np.array([[opts.fx, 0, opts.cx], [0, opts.fy, opts.cy], [0, 0, 1]])
    scores = []
    for kid, c2w in enumerate(kf_c2ws):
        w2c = np.linalg.inv(np.asarray(c2w))
        cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        # the reference scores overlap WITHOUT the x-flip
        uv = cam @ K.T
        z = uv[:, 2:3] + 1e-5
        uv = uv[:, :2] / z
        edge = 20
        mask = ((uv[:, 0] < W - edge) & (uv[:, 0] > edge)
                & (uv[:, 1] < H - edge) & (uv[:, 1] > edge)
                & (z[:, 0] < 0))
        scores.append((kid, mask.mean()))
    good = [kid for kid, s in sorted(scores, key=lambda x: -x[1]) if s > 0]
    perm = rs.permutation(np.array(good, dtype=int)) if good else []
    return list(perm[:k])
