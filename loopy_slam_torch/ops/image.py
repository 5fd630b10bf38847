"""Image ops (port of loopy_slam_tpu/ops/image.py): the bilinear depth
lookup of the mapper's frustum mask, in torch, and the host-side gradient
utilities of the dynamic query radius and the color-gradient pixel picks.

The gradient utilities stay numpy on the host, as in the JAX package:
the picks come from `np.argpartition` and the caller's numpy generator, so
the port's picks are bit-equal to the reference's; a torch Sobel on the
card would round differently and pick other pixels.
"""

from __future__ import annotations

import numpy as np
import torch


def bilinear_sample(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear sample img[H, W] at float pixel coords (u=col, v=row).
    Out-of-image taps contribute zero."""
    H, W = img.shape
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0

    def tap(vv, uu, w):
        inb = (uu >= 0) & (uu <= W - 1) & (vv >= 0) & (vv <= H - 1)
        uc = torch.clamp(uu.to(torch.int64), 0, W - 1)
        vc = torch.clamp(vv.to(torch.int64), 0, H - 1)
        return torch.where(inb, img[vc, uc] * w, torch.zeros((), device=img.device))

    return (tap(v0, u0, (1 - du) * (1 - dv))
            + tap(v0, u0 + 1, du * (1 - dv))
            + tap(v0 + 1, u0, (1 - du) * dv)
            + tap(v0 + 1, u0 + 1, du * dv))


# --------------------------- host-side (numpy) ----------------------------

_SOBEL = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], np.float64) / 4.0


def rgb2gray(rgb: np.ndarray) -> np.ndarray:
    """skimage-compatible luminance (ITU-R 601-2 weights)."""
    return rgb @ np.array([0.2125, 0.7154, 0.0721])


def _conv2_reflect(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    p = np.pad(img, 1, mode="reflect")
    out = np.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            out += k[dy, dx] * p[dy:dy + img.shape[0], dx:dx + img.shape[1]]
    return out


def sobel_grad_mag(gray: np.ndarray) -> np.ndarray:
    """sqrt(sobel_h^2 + sobel_v^2), skimage kernel normalization."""
    gh = _conv2_reflect(gray, _SOBEL)
    gv = _conv2_reflect(gray, _SOBEL.T)
    return np.sqrt(gh * gh + gv * gv)


def dynamic_radius_maps(color: np.ndarray, radius_add_max, radius_add_min,
                        radius_query_ratio, color_grad_threshold):
    """Per-pixel add/query radii (float32 (H, W) each) from the color
    gradient magnitude: the piecewise-linear map [0, 0.01, thr] ->
    [r_max, r_max, r_min] on the clipped gradient; query = ratio * add."""
    g = np.clip(sobel_grad_mag(rgb2gray(color)), 0.0, color_grad_threshold)
    t = np.clip((g - 0.01) / max(color_grad_threshold - 0.01, 1e-12), 0.0, 1.0)
    r_add = radius_add_max + (radius_add_min - radius_add_max) * t
    r_query = radius_query_ratio * r_add
    return r_add.astype(np.float32), r_query.astype(np.float32)


def select_pixels_by_grad(H0, H1, W0, W1, n, color: np.ndarray, ratio=15,
                          gt_depth=None, depth_limit=False):
    """Flat (row-major) indices of the top ratio*n color-gradient pixels
    that lie in rows [H0, H1) and cols [W0, W1) (and, given gt_depth, have
    depth > 0, and <= 5 m with depth_limit). Returns (flat_indices,
    grad_mag); the caller draws its pixels from this pool."""
    grad_mag = sobel_grad_mag(rgb2gray(color))
    img_size = color.shape[:2]
    k = min(ratio * n, grad_mag.size - 1)
    sel = np.argpartition(grad_mag, -k, axis=None)[-k:]
    h, w = np.unravel_index(sel, img_size)
    mask = (h >= H0) & (h < H1) & (w >= W0) & (w < W1)
    if gt_depth is not None:
        dv = gt_depth[h, w]
        mask &= (dv > 0.0) & ((dv <= 5.0) if depth_limit else True)
    h, w = h[mask], w[mask]
    return np.ravel_multi_index(np.array([h, w]), img_size), grad_mag
