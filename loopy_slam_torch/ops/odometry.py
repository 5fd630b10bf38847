"""Direct RGB-D frame-to-frame odometry: a multi-scale photometric and
geometric Gauss-Newton solve, the visual-odometer motion model of
tracking.visual_odometer (port of loopy_slam_tpu/ops/odometry.py).

Residuals per valid source pixel p with depth d:
  photometric  I_tgt(pi(T p)) - I_src(p)
  geometric    w_geo * (D_tgt(pi(T p)) - z(T p))
minimized over xi in se(3) by Gauss-Newton with Huber weights, coarse to
fine over an image pyramid (3 levels x 30 iterations, every second pixel).
The Jacobian is exact: forward-mode differentiation (torch.func.jacfwd) of
the residuals through the bilinear samplers at xi = 0. Everything stays on
the frames' device; the caller reads the 4x4 result once per frame.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.func import jacfwd

from .image import bilinear_sample
from .lie import se3_exp

_GRAY = (0.2125, 0.7154, 0.0721)


def _downsample2(img):
    H, W = img.shape[:2]
    img = img[:H - H % 2, :W - W % 2]
    return 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                   + img[0::2, 1::2] + img[1::2, 1::2])


def _level(gray, depth, intr, k: int):
    """Gray and depth average-pooled k times, with the intrinsics of that
    level."""
    fx, fy, cx, cy = intr
    for _ in range(k):
        gray = _downsample2(gray)
        depth = _downsample2(depth)
        fx, fy = fx / 2, fy / 2
        cx, cy = (cx + 0.5) / 2 - 0.5, (cy + 0.5) / 2 - 0.5
    return gray, depth, (fx, fy, cx, cy)


def _residuals(xi, T, src_pts, src_int, tgt_gray, tgt_depth, intr,
               w_geo: float):
    fx, fy, cx, cy = intr
    Tc = se3_exp(xi) @ T
    p = src_pts @ Tc[:3, :3].T + Tc[:3, 3]
    z = -p[:, 2]
    zc = torch.clamp(z, min=1e-6)
    u = fx * p[:, 0] / zc + cx
    v = -fy * p[:, 1] / zc + cy
    H, W = tgt_gray.shape
    inb = (z > 1e-4) & (u >= 1) & (u <= W - 2) & (v >= 1) & (v <= H - 2)
    it = bilinear_sample(tgt_gray, u, v)
    dt = bilinear_sample(tgt_depth, u, v)
    zero = torch.zeros((), device=z.device)
    r_i = torch.where(inb, it - src_int, zero)
    r_g = torch.where(inb & (dt > 0), w_geo * (dt - z), zero)
    r = torch.cat([r_i, r_g])
    return r, r


@torch.no_grad()
def rgbd_odometry(src_color, src_depth, tgt_color, tgt_depth,
                  intr: Tuple[float, float, float, float],
                  n_levels: int = 3, iters: int = 30, stride: int = 2,
                  w_geo: float = 5.0, huber: float = 0.1) -> torch.Tensor:
    """Relative transform T (4x4 tensor) with p_tgt_cam = T p_src_cam, from
    two frames' (H, W, 3) color in [0, 1] and (H, W) depth. The caller
    composes the camera motion: c2w_new = c2w_prev @ inv(T)."""
    dev = src_color.device
    w = torch.tensor(_GRAY, dtype=torch.float32, device=dev)
    sg, tg = src_color @ w, tgt_color @ w
    T = torch.eye(4, device=dev)
    eye6 = 1e-6 * torch.eye(6, device=dev)
    xi0 = torch.zeros(6, device=dev)
    for level in range(n_levels - 1, -1, -1):
        g_s, d_s, li = _level(sg, src_depth, intr, level)
        g_t, d_t, _ = _level(tg, tgt_depth, intr, level)
        fx, fy, cx, cy = li
        H, W = g_s.shape
        vv, uu = torch.meshgrid(
            torch.arange(0, H, stride, dtype=torch.float32, device=dev),
            torch.arange(0, W, stride, dtype=torch.float32, device=dev),
            indexing="ij")
        uu, vv = uu.reshape(-1), vv.reshape(-1)
        ui, vi = uu.long(), vv.long()
        d = d_s[vi, ui]
        valid = d > 0
        dirs = torch.stack([(uu - cx) / fx, -(vv - cy) / fy,
                            -torch.ones_like(uu)], -1)
        pts = torch.where(valid[:, None], dirs * d[:, None],
                          torch.zeros((), device=dev))
        ints = g_s[vi, ui]
        for _ in range(iters):
            J, r = jacfwd(
                lambda xi: _residuals(xi, T, pts, ints, g_t, d_t, li,
                                      w_geo), has_aux=True)(xi0)
            wt = 1.0 / torch.clamp(torch.abs(r) / huber, min=1.0)  # Huber
            Hm = J.T @ (wt[:, None] * J)
            b = J.T @ (wt * r)
            # solve_ex: no singularity check, so no host sync per step
            dx = -torch.linalg.solve_ex(Hm + eye6, b)[0]
            T = se3_exp(dx) @ T
    return T
