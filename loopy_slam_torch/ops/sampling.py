"""Pixel/ray sampling and depth-guided z-value generation (port of
loopy_slam_tpu/ops/sampling.py). Fixed-size batches plus a validity mask;
the random pixel picks come from a draw object (ops/draws.py)."""

from __future__ import annotations

import torch

from .camera import rays_from_uv
from .masked import masked_max, masked_median


def sample_pixels(draw, H0, H1, W0, W1, n, depth, color):
    """Uniformly sample n pixels from rows [H0,H1), cols [W0,W1).

    Draws, in order: rows j (n,), then cols i (n,). Returns
    (i_cols, j_rows, depth_n, color_n) with float coordinates.
    """
    j = draw.randint((n,), H0, H1)
    i = draw.randint((n,), W0, W1)
    return i.float(), j.float(), depth[j, i], color[j, i]


def sample_rays(draw, H0, H1, W0, W1, n, c2w, depth, color, fx, fy, cx, cy,
                depth_limit=None):
    """Sample n rays with gt depth/color and validity mask (depth > 0, and
    < depth_limit if set). Same draws as sample_pixels."""
    i, j, d, c = sample_pixels(draw, H0, H1, W0, W1, n, depth, color)
    rays_o, rays_d = rays_from_uv(i, j, c2w, fx, fy, cx, cy)
    mask = d > 0
    if depth_limit is not None:
        mask = mask & (d < depth_limit)
    return rays_o, rays_d, d, c, mask, i.long(), j.long()


def inside_mask_from_depth(gt_depth, valid):
    """Outlier gate: depth <= min(10*median, 1.2*max) over the valid batch."""
    med = masked_median(gt_depth, valid)
    mx = masked_max(gt_depth, valid, fill=0.0)
    return valid & (gt_depth <= torch.minimum(10.0 * med, 1.2 * mx))


def surface_z_vals(gt_depth, valid, n_surface, near_end_surface,
                   far_end_surface, near_end, far_fallback=10.0):
    """Depth-guided sample depths per ray, (R, n_surface): stratified in
    [near_end_surface*d, far_end_surface*d] for rays with depth, a uniform
    [near_end, far] linspace for zero-depth rays."""
    dev = gt_depth.device
    t = torch.linspace(0.0, 1.0, n_surface, device=dev)
    d = gt_depth[:, None]
    z_surface = near_end_surface * d * (1.0 - t) + far_end_surface * d * t

    mean_d = torch.sum(torch.where(valid, gt_depth, 0.0)) / torch.clamp(
        torch.sum(valid), min=1)
    max_d = masked_max(gt_depth, valid, fill=0.0)
    far_bb = torch.minimum(5.0 * mean_d, 1.2 * max_d)
    far = torch.where(max_d > 0,
                      torch.minimum(torch.clamp(far_bb, min=0.0), 1.2 * max_d),
                      torch.full((), far_fallback, device=dev))
    z_uniform = (near_end * (1.0 - t) + far * t).expand(z_surface.shape)

    has_depth = (gt_depth > 0)[:, None]
    return torch.where(has_depth, z_surface, z_uniform)


def pixels_to_points(rays_o, rays_d, z_vals):
    """(R,3),(R,3),(R,S) -> sample positions (R,S,3)."""
    return rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
