"""Ray renderer: z-vals -> k-NN -> feature interp -> MLPs -> composite.

Port of loopy_slam_tpu/models/renderer.py. One k-NN query is shared by the
geometry and color decoders, and one gather fetches the packed
[geometry || color || xyz] neighbour rows. Squared distances are recomputed
differentiably from the gathered positions, so pose gradients flow through
the sample positions and feature gradients through the gathered features.

Random draws (ops/draws.py), in order, per decode: the geometry noise
features (N, c), then, in the color stage, the color noise features (N, c).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import knn
from ..ops.compositing import composite
from ..ops.sampling import pixels_to_points, surface_z_vals
from .decoder import (col_forward, geo_forward, interp_weights,
                      interpolate_features, neighbor_transform)


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
                stage: str, views_d=None):
    """Decode occupancy (and color) at sample positions (N, 3). Returns
    (occ_logits (N,), rgb (N,3), has_neighbors (N,))."""
    rq = opts.radius_query
    D_idx, I, nn_count = knn.query(grid, map_pos, pts.detach(), opts.nn_num,
                                   rq)
    both = gather_featpos(feats, map_pos, I)
    return decode_neighbors(dec, pts, draw, opts, stage, D_idx, both,
                            nn_count, rq, views_d)


def decode_neighbors(dec, pts, draw, opts: RenderOptions, stage: str,
                     D_idx, both, nn_count, rq, views_d=None):
    """Decode occupancy/color from already-fetched neighbour data. `both`
    is the gathered (N, k, 2c+3) block; D_idx the index distances (only
    thresholded); distances are recomputed from the gathered positions."""
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
                     ray_valid, draw, opts: RenderOptions, stage: str):
    """Render a fixed-size batch of rays. Returns (depth, depth_var, color,
    valid_ray_mask), each (R, ...). The sample-near-pcl z-vals and the
    per-ray query radius of the reference are not in this slice (see
    LoopySLAM's config check)."""
    if opts.sample_near_pcl:
        raise NotImplementedError(
            "rendering.sample_near_pcl is not ported yet (ROADMAP.md "
            "Queue 1 item 18)")
    R = rays_o.shape[0]
    S = opts.n_surface
    z_vals = surface_z_vals(gt_depth, ray_valid, S, opts.near_end_surface,
                            opts.far_end_surface, opts.near_end)
    pts = pixels_to_points(rays_o, rays_d, z_vals).reshape(-1, 3)
    views_d = None
    if opts.use_view_direction:
        views_d = torch.repeat_interleave(rays_d, S, dim=0)
    occ, rgb, has_neighbors = eval_points(
        dec, map_pos, grid, feats, pts, draw, opts, stage, views_d=views_d)
    valid_ray = torch.sum(has_neighbors.reshape(R, S), dim=-1) >= (S // 2 + 1)
    depth, depth_var, color, _ = composite(
        rgb.reshape(R, S, 3), occ.reshape(R, S), z_vals, opts.sigmoid_coef)
    depth = torch.where(gt_depth > 0, depth, torch.zeros((), device=depth.device))
    return depth, depth_var, color, valid_ray
