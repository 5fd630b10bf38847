"""Image/render quality metrics: masked PSNR, SSIM, MS-SSIM, depth L1
(numpy; a copy of loopy_slam_tpu/utils/metrics.py) and LPIPS (utils/lpips.py,
torch on the device).

Replaces the reference's torchmetrics/pytorch-msssim dependencies
(reference src/Mapper.py:1133-1147, src/tools/eval_images.py:33-71).
`lpips()` returns None unless a weights bundle is configured
(cfg rendering.lpips_weights; the repo ships
pretrained/lpips_alex_randfeat.npz).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def masked_psnr(img: np.ndarray, ref: np.ndarray,
                mask: Optional[np.ndarray] = None) -> float:
    """PSNR over masked-in pixels (reference masked_psnr, common.py:479-516).
    Images in [0,1]."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    if mask is None:
        mask = np.ones(img.shape[:2], bool)
    diff2 = ((img - ref) ** 2)[mask]
    mse = diff2.mean() if diff2.size else np.inf
    if mse <= 0:
        return float("inf")
    return float(10.0 * np.log10(1.0 / mse))


def _gaussian_kernel(size=11, sigma=1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2(img, k):
    """Separable valid-mode convolution along H and W for (H,W,C)."""
    from numpy.lib.stride_tricks import sliding_window_view

    n = len(k)
    w = sliding_window_view(img, n, axis=0)
    img = np.einsum("hwcx,x->hwc", w, k)
    w = sliding_window_view(img, n, axis=1)
    return np.einsum("hwcx,x->hwc", w, k)


def ssim(img: np.ndarray, ref: np.ndarray, data_range=1.0) -> float:
    """Mean SSIM (Wang et al.), 11x11 gaussian window, per-channel mean."""
    img = np.atleast_3d(np.asarray(img, np.float64))
    ref = np.atleast_3d(np.asarray(ref, np.float64))
    k = _gaussian_kernel()
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    mu1 = _filter2(img, k)
    mu2 = _filter2(ref, k)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = _filter2(img * img, k) - mu1_sq
    s2 = _filter2(ref * ref, k) - mu2_sq
    s12 = _filter2(img * ref, k) - mu12
    m = ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return float(m.mean())


def _ssim_cs(img, ref, data_range=1.0):
    k = _gaussian_kernel()
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    mu1 = _filter2(img, k)
    mu2 = _filter2(ref, k)
    s1 = _filter2(img * img, k) - mu1 ** 2
    s2 = _filter2(ref * ref, k) - mu2 ** 2
    s12 = _filter2(img * ref, k) - mu1 * mu2
    l = (2 * mu1 * mu2 + C1) / (mu1 ** 2 + mu2 ** 2 + C1)
    cs = (2 * s12 + C2) / (s1 + s2 + C2)
    return float(l.mean()), float(cs.mean())


def ms_ssim(img: np.ndarray, ref: np.ndarray, data_range=1.0) -> float:
    """Multi-scale SSIM (Wang et al. 2003) with the standard 5 scale
    weights — parity with pytorch_msssim.ms_ssim as used by the reference
    (Mapper.py:1137-1138)."""
    weights = [0.0448, 0.2856, 0.3001, 0.2363, 0.1333]
    img = np.atleast_3d(np.asarray(img, np.float64))
    ref = np.atleast_3d(np.asarray(ref, np.float64))
    vals = []
    for i in range(len(weights)):
        l, cs = _ssim_cs(img, ref, data_range)
        vals.append(l if i == len(weights) - 1 else cs)
        if i < len(weights) - 1:
            if min(img.shape[0], img.shape[1]) < 22:
                # too small to downscale further: renormalize weights
                vals[-1] = l
                weights = weights[:i + 1]
                break
            img = _downsample2(img)
            ref = _downsample2(ref)
    vals = np.clip(vals, 1e-6, None)
    weights = np.asarray(weights) / np.sum(weights)
    return float(np.prod(vals ** weights))


def _downsample2(img):
    H, W = img.shape[:2]
    H2, W2 = H - H % 2, W - W % 2
    img = img[:H2, :W2]
    return 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                   + img[0::2, 1::2] + img[1::2, 1::2])


def depth_l1(depth: np.ndarray, ref: np.ndarray,
             mask: Optional[np.ndarray] = None) -> float:
    """Mean |d - d_ref| over pixels where both are valid (>0)."""
    depth = np.asarray(depth, np.float64)
    ref = np.asarray(ref, np.float64)
    m = (ref > 0) & (depth > 0)
    if mask is not None:
        m &= mask
    return float(np.abs(depth - ref)[m].mean()) if m.any() else float("nan")


def lpips(img, ref, weights_path: Optional[str] = None, device=None):
    """Perceptual distance (LPIPS, AlexNet variant — utils/lpips.py), on
    `device` (the card unless the caller asks for the CPU).

    Returns None only when no weights bundle is configured; with
    `rendering.lpips_weights` pointing at a bundle (the shipped default,
    or one produced by scripts/convert_lpips_weights.py) it returns the
    metric. A configured-but-unreadable path raises rather than silently
    degrading. A relative path resolves against the working directory,
    then the repo root.
    """
    if weights_path is None:
        return None
    if not os.path.isabs(weights_path) and not os.path.exists(weights_path):
        # the shipped default is repo-relative; resolve it regardless of CWD
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        cand = os.path.join(repo, weights_path)
        if os.path.exists(cand):
            weights_path = cand
    from .lpips import lpips_alex
    return lpips_alex(img, ref, weights_path, device)
