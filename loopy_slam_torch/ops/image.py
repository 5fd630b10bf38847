"""Image ops (part of loopy_slam_tpu/ops/image.py): the bilinear depth
lookup of the mapper's frustum mask. The gradient utilities of the JAX
module (dynamic radius, color-gradient pixel picks) are not in this slice
(ROADMAP.md Queue 1 item 15)."""

from __future__ import annotations

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
