"""Mapping: point insertion, frustum feature selection, and the two-stage
(geometry -> color) map optimization.

Port of loopy_slam_tpu/mapping/mapper.py for one device. Each iteration
optimizes the decoders and the FULL feature buffer with gradients masked
by the frustum-selection mask and the decoders' trainable mask; the Adam
state is fresh per mapping frame and threads across chunks. With
pixel_pool_factor > 0 each chunk samples a pool of rays once, runs the
k-NN once over it, and every iteration draws its rays from the pool.

Loss: depth L1 over (gt>0 & valid_ray & finite & inside) rays; the color
stage adds w_color_loss * color L1 against targets clipped to
[1/510, 1 - 1/510].

Random draws (ops/draws.py), in order. Insertion: rows (n,), cols (n,),
then the new features' normals. A pooled chunk: the pool's rows (F, P)
and cols (F, P); then per iteration the picks (F, pix_per_frame) and the
decode's noise (geometry, then color in the color stage). Unpooled
iteration: rows (F, pix) and cols (F, pix), then the decode's noise.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..models.renderer import (RenderOptions, decode_neighbors,
                               gather_featpos, render_batch_ray)
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
        )


# ---------------------------------------------------------------------------
# Point insertion
# ---------------------------------------------------------------------------

def sample_insert_candidates(draw, gt_color, gt_depth, cur_c2w, prev_c2w,
                             opts: MapperOptions, n_rays: int,
                             overlap: Optional[bool] = None):
    """Sample n_rays pixels and apply the previous-frustum overlap split.
    Returns (rays_o, rays_d, d, c, valid)."""
    rays_o, rays_d, d, c, valid, _, _ = sample_rays(
        draw, 0, opts.H, 0, opts.W, n_rays, cur_c2w, gt_depth, gt_color,
        opts.fx, opts.fy, opts.cx, opts.cy)
    if overlap is not None:
        pts = rays_o + rays_d * d[:, None]
        uv, _ = project_points(pts, invert_c2w(prev_c2w),
                               opts.fx, opts.fy, opts.cx, opts.cy)
        inside = ((uv[:, 0] > 0) & (uv[:, 0] < opts.W)
                  & (uv[:, 1] > 0) & (uv[:, 1] < opts.H))
        valid = valid & (inside if overlap else ~inside)
    return rays_o, rays_d, d, c, valid


@torch.no_grad()
def add_points_from_frame(state: MapState, gt_color, gt_depth, cur_c2w,
                          prev_c2w, draw, mopts: MapOptions,
                          opts: MapperOptions, n_rays: int,
                          overlap: Optional[bool] = None):
    """Sample n_rays pixels of the current frame and insert surface points.
    overlap=None: no frustum split (frame 0); False: keep only points
    OUTSIDE the previous mapped frame's frustum; True: only INSIDE it."""
    rays_o, rays_d, d, c, valid = sample_insert_candidates(
        draw, gt_color, gt_depth, cur_c2w, prev_c2w, opts, n_rays, overlap)
    return add_points(state, mopts, draw, rays_o, rays_d, d, c, valid)


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

def _window_rays(draw, kf_color, kf_depth, kf_c2w, opts: MapperOptions,
                 n: int):
    """n rays per window frame: (ro, rd, d, c, valid), each (F, n, ...)."""
    F = kf_color.shape[0]
    j = draw.randint((F, n), 0, opts.H)
    i = draw.randint((F, n), 0, opts.W)
    f = torch.arange(F, device=kf_color.device)[:, None]
    d = kf_depth[f, j, i]
    c = kf_color[f, j, i]
    ro, rd = rays_from_uv(i.float(), j.float(), kf_c2w, opts.fx, opts.fy,
                          opts.cx, opts.cy)
    return ro, rd, d, c, d > 0


def _loss_terms(d, c, inside, valid_ray, depth, color, stage,
                opts: MapperOptions):
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


def _map_loss(dec, feats, map_pos, grid, kf_color, kf_depth, kf_c2w, draw,
              stage, opts: MapperOptions, ropts: RenderOptions,
              pix_per_frame: int):
    """One mapping iteration's loss over pix_per_frame fresh rays from each
    of the F window frames (last = current frame)."""
    ro, rd, d, c, valid = _window_rays(draw, kf_color, kf_depth, kf_c2w,
                                       opts, pix_per_frame)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    d, valid, c = d.reshape(-1), valid.reshape(-1), c.reshape(-1, 3)
    med = masked_median(d, valid)
    mx = masked_max(d, valid, fill=0.0)
    inside = valid & (d <= torch.minimum(10.0 * med, 1.2 * mx))
    depth, _var, color, valid_ray = render_batch_ray(
        dec, map_pos, grid, feats, ro, rd, d, inside, draw, ropts, stage)
    return _loss_terms(d, c, inside, valid_ray, depth, color, stage, opts)


class _NeighborPool(NamedTuple):
    """Per-chunk ray pool with its k-NN done; leading axes (F, P)."""

    pts: torch.Tensor     # (F, P, S, 3) sample positions
    z_vals: torch.Tensor  # (F, P, S)
    d: torch.Tensor       # (F, P) gt depth
    c: torch.Tensor       # (F, P, 3) gt color
    valid: torch.Tensor   # (F, P) bool
    rd: torch.Tensor      # (F, P, 3) ray directions
    D: torch.Tensor       # (F, P, S*k) index distances
    I: torch.Tensor       # (F, P, S*k) int32 neighbor ids
    nn: torch.Tensor      # (F, P, S) int32 in-radius counts


@torch.no_grad()
def _build_pool(map_pos, grid, kf_color, kf_depth, kf_c2w, draw,
                opts: MapperOptions, ropts: RenderOptions,
                P: int) -> _NeighborPool:
    """Sample the ray pool and run the k-NN once over all its samples (one
    kernel launch on the card)."""
    F = kf_color.shape[0]
    S, k = ropts.n_surface, ropts.nn_num
    ro, rd, d, c, valid = _window_rays(draw, kf_color, kf_depth, kf_c2w,
                                       opts, P)
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
    D, I, nn = knn.query_chunked(grid, map_pos, pts.reshape(N, 3), k,
                                 ropts.radius_query)
    return _NeighborPool(pts=pts, z_vals=z, d=d, c=c, valid=valid, rd=rd,
                         D=D.reshape(F, P, S * k), I=I.reshape(F, P, S * k),
                         nn=nn.reshape(F, P, S))


def _map_loss_pool(dec, feats, pool: _NeighborPool, map_pos, draw, stage,
                   opts: MapperOptions, ropts: RenderOptions,
                   pix_per_frame: int):
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
    views_d = None
    if ropts.use_view_direction:
        views_d = torch.repeat_interleave(take(pool.rd), S, dim=0)

    med = masked_median(d, valid)
    mx = masked_max(d, valid, fill=0.0)
    inside = valid & (d <= torch.minimum(10.0 * med, 1.2 * mx))

    both = gather_featpos(feats, map_pos, I)
    occ, rgb, has_neighbors = decode_neighbors(
        dec, pts, draw, ropts, stage, D_idx, both, nn, ropts.radius_query,
        views_d=views_d)
    R = F * pix_per_frame
    valid_ray = torch.sum(has_neighbors.reshape(R, S), dim=-1) >= (S // 2 + 1)
    depth, _var, color, _ = composite(
        rgb.reshape(R, S, 3), occ.reshape(R, S), z_vals, ropts.sigmoid_coef)
    depth = torch.where(d > 0, depth, torch.zeros((), device=d.device))
    return _loss_terms(d, c, inside, valid_ray, depth, color, stage, opts)


def _optimize_map_impl(dec, feat, adam_state, dec_mask: Dict[str, bool],
                       feat_mask, map_pos, grid, kf_color, kf_depth, kf_c2w,
                       draw, n_geo_iters: int, n_col_iters: int,
                       lrs_geo, lrs_col, opts: MapperOptions,
                       ropts: RenderOptions, pix_per_frame: int):
    """Run a chunk of the geometry -> color mapping optimization.

    dec: Decoders (updated in place); feat: (cap, 2c) packed features;
    adam_state: ops.adam.AdamState over [decoder params..., feat] (None to
    start fresh); dec_mask: {param name: trainable}; feat_mask: (cap,) bool
    frustum-selected rows; lrs_geo/lrs_col: [decoders_lr, geometry_lr,
    color_lr]. Returns (feat, adam_state, (geo_loss, col_loss, n_rays)).
    """
    names = [n for n, _ in dec.named_parameters()]
    params = [p for _, p in dec.named_parameters()]
    dec_on = [dec_mask[n] for n in names]
    fm = feat_mask[:, None].float()
    c = feat.shape[1] // 2
    if adam_state is None:
        adam_state = adam.init(params + [feat])
    use_pool = opts.pixel_pool_factor > 0 and not ropts.sample_near_pcl
    pool = None
    if use_pool:
        pool = _build_pool(map_pos, grid, kf_color, kf_depth, kf_c2w, draw,
                           opts, ropts, opts.pixel_pool_factor * pix_per_frame)
    aux = (torch.zeros((), device=feat.device),) * 3
    for stage, n_iters, lrs in (("geometry", n_geo_iters, lrs_geo),
                                ("color", n_col_iters, lrs_col)):
        pool_this_stage = use_pool and (stage != "color"
                                        or opts.pool_color_stage)
        lr_feat = torch.cat([torch.full((c,), float(lrs[1])),
                             torch.full((c,), float(lrs[2]))]).to(feat.device)
        lr_list = [float(lrs[0])] * len(params) + [lr_feat]
        for _ in range(n_iters):
            feat_v = feat.detach().requires_grad_(True)
            if pool_this_stage:
                loss, aux = _map_loss_pool(dec, feat_v, pool, map_pos, draw,
                                           stage, opts, ropts, pix_per_frame)
            else:
                loss, aux = _map_loss(dec, feat_v, map_pos, grid, kf_color,
                                      kf_depth, kf_c2w, draw, stage, opts,
                                      ropts, pix_per_frame)
            grads = torch.autograd.grad(loss, params + [feat_v],
                                        allow_unused=True)
            grads = [g if (on and g is not None) else None
                     for g, on in zip(grads[:-1], dec_on)] \
                + [grads[-1] * fm if grads[-1] is not None else None]
            with torch.no_grad():
                new, adam_state = adam.update(
                    [p.detach() for p in params] + [feat_v.detach()], grads,
                    adam_state, lr_list)
                for p, q in zip(params, new[:-1]):
                    p.copy_(q)
                feat = new[-1]
    return feat, adam_state, aux


optimize_map = _optimize_map_impl


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
