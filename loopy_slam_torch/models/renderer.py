"""Ray renderer: z-vals -> k-NN -> feature interp -> MLPs -> composite.

Port of loopy_slam_tpu/models/renderer.py. One k-NN query is shared by the
geometry and color decoders, and one gather fetches the packed
[geometry || color || xyz] neighbour rows. Squared distances are recomputed
differentiably from the gathered positions, so pose gradients flow through
the sample positions and feature gradients through the gathered features.

With model.encode_exposure, the color head goes through a frame's
exposure affine before its soft clamp and sigmoid: the one of the latent
`exposure_feat` when one is given (tracking, renders), else none at all:
the raw logits come back so that the mapper can apply each window frame's
own affine to its composited colors.

Random draws (ops/draws.py), in order, per decode: the geometry noise
features (N, c), then, in the color stage, the color noise features (N, c).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..mapping.point_cloud import sample_near_pcl_z_vals_raw
from ..ops import knn
from ..ops.compositing import composite
from ..ops.masked import masked_max
from ..ops.sampling import pixels_to_points, surface_z_vals
from .decoder import (col_forward, exposure_affine, geo_forward,
                      interp_weights, interpolate_features,
                      neighbor_transform)


class RenderOptions(NamedTuple):
    """Static rendering configuration, from the YAML config."""

    n_surface: int = 5
    near_end: float = 0.3
    near_end_surface: float = 0.98
    far_end_surface: float = 1.02
    sigmoid_coef: float = 0.1
    sample_near_pcl: bool = False
    nn_num: int = 8
    min_nn_num: int = 2
    radius_query: float = 0.08
    weighting: str = "distance"
    c_dim: int = 32
    encode_rel_pos_in_col: bool = True
    use_view_direction: bool = False
    encode_viewd: bool = True
    encode_exposure: bool = False

    @staticmethod
    def from_cfg(cfg, sigmoid_coef=None):
        return RenderOptions(
            n_surface=cfg["rendering"]["N_surface"],
            near_end=cfg["rendering"]["near_end"],
            near_end_surface=cfg["rendering"]["near_end_surface"],
            far_end_surface=cfg["rendering"]["far_end_surface"],
            sigmoid_coef=(sigmoid_coef if sigmoid_coef is not None
                          else cfg["rendering"]["sigmoid_coef_mapper"]),
            sample_near_pcl=cfg["rendering"]["sample_near_pcl"],
            nn_num=cfg["pointcloud"]["nn_num"],
            min_nn_num=cfg["pointcloud"]["min_nn_num"],
            radius_query=cfg["pointcloud"]["radius_query"],
            weighting=cfg["pointcloud"]["nn_weighting"],
            c_dim=cfg["model"]["c_dim"],
            encode_rel_pos_in_col=cfg["model"]["encode_rel_pos_in_col"],
            use_view_direction=cfg["use_view_direction"],
            encode_viewd=cfg["model"]["encode_viewd"],
            encode_exposure=cfg["model"]["encode_exposure"],
        )


class _GatherFeatPos(torch.autograd.Function):
    """[feats || map_pos][I] with a backward that scatter-adds only the
    feature lanes (positions carry no gradient here)."""

    @staticmethod
    def forward(ctx, feats, map_pos, I):
        flat = I.reshape(-1).long()
        out = torch.cat([feats.index_select(0, flat),
                         map_pos.index_select(0, flat)], dim=-1)
        ctx.save_for_backward(flat)
        ctx.fshape = feats.shape
        return out.reshape(I.shape[0], I.shape[1], -1)

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        c2 = ctx.fshape[1]
        dfeats = None
        if ctx.needs_input_grad[0]:
            # index_add_ on CUDA sums with atomics: the order (and so the
            # last bits of a row hit by several neighbours) varies per run
            dfeats = torch.zeros(ctx.fshape, dtype=g.dtype,
                                 device=g.device).index_add_(
                0, flat, g[..., :c2].reshape(-1, c2))
        return dfeats, None, None


def gather_featpos(feats, map_pos, I):
    """take(concat([feats, map_pos], 1), I.flat) -> (N, k, 2c+3)."""
    return _GatherFeatPos.apply(feats, map_pos.detach(), I)


def eval_points(dec, map_pos, grid, feats, pts, draw, opts: RenderOptions,
                stage: str, views_d=None, r_query=None, exposure_feat=None,
                exposure_mlp=None):
    """Decode occupancy (and color) at sample positions (N, 3) with the
    query radius r_query, a (N,) tensor of per-sample radii or None for
    opts.radius_query. Returns (occ_logits (N,), rgb (N,3),
    has_neighbors (N,)); rgb is post-sigmoid unless encode_exposure with
    no exposure_feat (see decode_neighbors)."""
    rq = opts.radius_query if r_query is None else r_query
    D_idx, I, nn_count = knn.query(grid, map_pos, pts.detach(), opts.nn_num,
                                   rq)
    both = gather_featpos(feats, map_pos, I)
    return decode_neighbors(dec, pts, draw, opts, stage, D_idx, both,
                            nn_count, rq, views_d, exposure_feat,
                            exposure_mlp)


def decode_neighbors(dec, pts, draw, opts: RenderOptions, stage: str,
                     D_idx, both, nn_count, rq, views_d=None,
                     exposure_feat=None, exposure_mlp=None):
    """Decode occupancy/color from already-fetched neighbour data. `both`
    is the gathered (N, k, 2c+3) block; D_idx the index distances (only
    thresholded); distances are recomputed from the gathered positions.
    With opts.encode_exposure, the color logits go through the affine of
    the latent exposure_feat (by exposure_mlp's parameters, else
    dec.col.exposure) before the clamp and sigmoid; without a latent they
    come back raw, for the caller to apply the exposure."""
    n = pts.shape[0]
    c = opts.c_dim
    geo_n, col_n = both[..., :c], both[..., c:2 * c]
    neighbor_pos = both[..., 2 * c:].detach()
    diff = neighbor_pos - pts[:, None, :]
    D = torch.sum(diff * diff, dim=-1)
    # empty candidate slots -> out-of-radius marker
    D = torch.where(D_idx < 1e9, D, torch.full((), 1e4, device=D.device))

    r2_bound = torch.as_tensor(rq, dtype=torch.float32, device=pts.device) ** 2
    if r2_bound.dim() == 1:
        r2_bound = r2_bound[:, None]
    w = interp_weights(D, r2_bound, opts.weighting)
    has_neighbors = nn_count >= opts.min_nn_num
    c_geo = interpolate_features(geo_n, w, has_neighbors,
                                 draw.normal((n, c)))
    occ = geo_forward(dec.geo, pts, c_geo)
    occ = torch.where(has_neighbors, occ,
                      torch.full((), -100.0, device=occ.device))

    if stage == "geometry":
        return occ, torch.zeros((n, 3), dtype=pts.dtype,
                                device=pts.device), has_neighbors

    if opts.encode_rel_pos_in_col:
        rel = neighbor_pos - pts[:, None, :]
        col_n = neighbor_transform(dec.col, col_n, rel)
    c_col = interpolate_features(col_n, w, has_neighbors,
                                 draw.normal((n, c)))
    rgb = col_forward(dec.col, pts, c_col, views_d, opts.use_view_direction,
                      opts.encode_viewd)
    if opts.encode_exposure:
        if exposure_feat is not None:
            rot, trans = exposure_affine(
                dec.col.exposure if exposure_mlp is None else exposure_mlp,
                exposure_feat)
            rgb = torch.sigmoid(soft_clamp_logits(rgb @ rot + trans))
    else:
        rgb = torch.sigmoid(soft_clamp_logits(rgb))
    return occ, rgb, has_neighbors


_CLAMP_LIMIT = 12.0
_CLAMP_KNEE = 24.0


def soft_clamp_logits(x):
    """Bound pre-sigmoid color logits with a rational clamp that folds back
    past |x| = 24 (the reference's guard against sigmoid saturation latch
    and saturated-target drift): x / (1 + |x|/12) inside the knee, a
    rational decline toward 8 - 24 = -16 (times sign x) beyond it."""
    a = torch.abs(x)
    core = x / (1.0 + a / _CLAMP_LIMIT)
    k_val = _CLAMP_KNEE / (1.0 + _CLAMP_KNEE / _CLAMP_LIMIT)      # = 8
    slope = 1.0 / (1.0 + _CLAMP_KNEE / _CLAMP_LIMIT) ** 2         # = 1/9
    span = 2.0 * _CLAMP_LIMIT                                     # = 24
    excess = torch.clamp(a - _CLAMP_KNEE, min=0.0)
    decline = span * excess / (excess + span / slope)
    return torch.where(a <= _CLAMP_KNEE, core,
                       torch.sign(x) * (k_val - decline))


def render_batch_ray(dec, map_pos, grid, feats, rays_o, rays_d, gt_depth,
                     ray_valid, draw, opts: RenderOptions, stage: str,
                     r_query=None, exposure_feat=None, exposure_mlp=None,
                     eval_fn=None):
    """Render a fixed-size batch of rays. `r_query` is a per-ray (R,)
    query radius (the dynamic radius), repeated once per sample, or None
    for opts.radius_query; exposure_feat/exposure_mlp: the exposure
    latent and MLP (see decode_neighbors). With opts.sample_near_pcl,
    zero-depth rays sample between the first two probe depths where the
    point cloud lies (mapping/point_cloud.sample_near_pcl_z_vals_raw, at
    the scalar radius_query, on detached rays) and a ray whose probe found
    fewer than two is invalid; their depths are kept. Without it,
    zero-depth rays render depth 0. eval_fn(pts, draw, stage, views_d, rq,
    exposure_feat, exposure_mlp) replaces the sample decode (the
    map-sharded ring k-NN, parallel/map_shard.py); its attribute
    `probe_occupied`, if any, replaces the probe's local k-NN. Returns
    (depth, depth_var, color, valid_ray_mask), each (R, ...)."""
    R = rays_o.shape[0]
    S = opts.n_surface
    z_vals = surface_z_vals(gt_depth, ray_valid, S, opts.near_end_surface,
                            opts.far_end_surface, opts.near_end)
    mask_rays_near_pcl = None
    if opts.sample_near_pcl:
        # far: the deepest surface sample of a valid ray with depth, at
        # least 1 m (padded rays of a render chunk carry depth 0)
        far = torch.clamp(masked_max(z_vals[:, -1].detach(),
                                     ray_valid & (gt_depth > 0), fill=0.0),
                          min=1.0)
        z_near, invalid = sample_near_pcl_z_vals_raw(
            map_pos, grid, rays_o.detach(), rays_d.detach(), opts.near_end,
            far, S, opts.radius_query, opts.nn_num,
            occupied_fn=getattr(eval_fn, "probe_occupied", None))
        has_depth = gt_depth > 0
        z_vals = torch.where(has_depth[:, None], z_vals, z_near)
        mask_rays_near_pcl = has_depth | ~invalid
    pts = pixels_to_points(rays_o, rays_d, z_vals).reshape(-1, 3)
    views_d = None
    if opts.use_view_direction:
        views_d = torch.repeat_interleave(rays_d, S, dim=0)
    rq = None
    if r_query is not None:
        rq = torch.repeat_interleave(r_query.reshape(-1), S, dim=0)
    if eval_fn is None:
        occ, rgb, has_neighbors = eval_points(
            dec, map_pos, grid, feats, pts, draw, opts, stage,
            views_d=views_d, r_query=rq, exposure_feat=exposure_feat,
            exposure_mlp=exposure_mlp)
    else:
        occ, rgb, has_neighbors = eval_fn(pts, draw, stage, views_d, rq,
                                          exposure_feat, exposure_mlp)
    valid_ray = torch.sum(has_neighbors.reshape(R, S), dim=-1) >= (S // 2 + 1)
    if mask_rays_near_pcl is not None:
        valid_ray = valid_ray & mask_rays_near_pcl
    depth, depth_var, color, _ = composite(
        rgb.reshape(R, S, 3), occ.reshape(R, S), z_vals, opts.sigmoid_coef)
    if not opts.sample_near_pcl:
        depth = torch.where(gt_depth > 0, depth,
                            torch.zeros((), device=depth.device))
    return depth, depth_var, color, valid_ray
