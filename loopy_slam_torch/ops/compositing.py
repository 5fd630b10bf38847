"""Occupancy-based volume compositing (port of
loopy_slam_tpu/ops/compositing.py): occupancy = sigmoid(coef * raw),
front-to-back alpha compositing, weight-normalized color/depth, and the
depth-variance uncertainty."""

from __future__ import annotations

import torch


def composite(raw_rgb, raw_occ, z_vals, coef: float = 0.1):
    """Alpha-composite along each ray.

    raw_rgb (R, S, 3), raw_occ (R, S) logits (-100 marks samples without
    neighbors), z_vals (R, S). Returns depth (R,), depth_var (R,),
    rgb (R, 3), weights (R, S).
    """
    alpha = torch.reciprocal(1.0 + torch.exp(-coef * raw_occ))
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), (1.0 - alpha + 1e-10)],
                  dim=-1),
        dim=-1)[:, :-1]
    weights = alpha * trans
    weights_sum = torch.sum(weights, dim=-1, keepdim=True) + 1e-10
    rgb = torch.sum(weights[..., None] * raw_rgb, dim=-2) / weights_sum
    depth = torch.sum(weights * z_vals, dim=-1) / weights_sum[..., 0]
    dev = z_vals - depth[..., None]
    depth_var = torch.sum(weights * dev * dev, dim=-1)
    return depth, depth_var, rgb, weights
