"""ORB features (FAST-9 keypoints, Harris ranking, steered BRIEF) in torch,
on the session's device.

The port's counterpart of loopy_slam_tpu/mapping/place_recognition.py's
extract_orb, which calls cv2.ORB_create() with its defaults; this module
computes the same features with torch ops, so place recognition runs where
OpenCV is not installed. It follows OpenCV's ORB step by step, with its
integer and float32 arithmetic reproduced where the result depends on it:

  * gray = (19596 R + 38470 G + 7470 B + 2^15) >> 16 of the uint8 image;
  * an 8-level pyramid at scale 1.2, each level the bit-exact bilinear
    resize (8-bit fixed-point coefficients) of the level above;
  * FAST-9 at threshold 20 with 3x3 non-max suppression on its corner
    score, keypoints at least 31 px from each level's border;
  * per level, the 2n best by FAST score, then the n best by the Harris
    response (7x7 block, k = 0.04, float32 as OpenCV evaluates it), ties
    at the cut kept; n splits 500 over the levels geometrically;
  * the angle of the intensity centroid over the radius-15 disc, through
    OpenCV's polynomial atan2 (degrees);
  * each level blurred by the 7x7, sigma 2 Gaussian (float32 kernel,
    reflect-101 border, fused multiply-adds in OpenCV's order, rounded to
    uint8), and 256 rotated point-pair tests (ops/orb_pattern.py) packed
    into 32 bytes.

tests/test_torch_orb.py holds each step against the installed cv2:
descriptors at keypoints passed in are bit-equal; the detector's keypoints
and angles are held by recall and tolerance. Descriptors are returned in
(level, row, column) order of their keypoints; OpenCV's order within a
level is its partial sort's and differs.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .orb_pattern import PATTERN_31

N_FEATURES = 500
N_LEVELS = 8
# OpenCV keeps the scale factor as a float: 1.2f, not 1.2
SCALE_FACTOR = float(np.float32(1.2))
EDGE_THRESHOLD = 31
PATCH_SIZE = 31
FAST_THRESHOLD = 20
HARRIS_K = np.float32(0.04)
HARRIS_BLOCK = 7

# cv2.getGaussianKernel(7, 2, CV_32F), exactly
_GAUSS7 = np.array([float.fromhex(h) for h in (
    "0x1.1f5f62p-4", "0x1.0c70fcp-3", "0x1.869472p-3", "0x1.ba95c0p-3",
    "0x1.869472p-3", "0x1.0c70fcp-3", "0x1.1f5f62p-4")], np.float32)

# FAST's 16-pixel Bresenham circle of radius 3, as (dx, dy)
_CIRCLE = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2),
           (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0),
           (-3, 1), (-2, 2), (-1, 3))

# OpenCV's fastAtan2 polynomial, in degrees (float32 products)
_F32 = np.float32
_DEG = _F32(180 / math.pi)
_ATAN_P = tuple(_F32(c) * _DEG for c in (
    0.9997878412794807, -0.3258083974640975, 0.1555786518463281,
    -0.04432655554792128))
_DBL_EPS_F32 = _F32(np.finfo(np.float64).eps)


class Keypoints(NamedTuple):
    """Detected keypoints, level-0 coordinates (x, y) like OpenCV's."""

    x: torch.Tensor         # (N,) float32
    y: torch.Tensor         # (N,) float32
    angle: torch.Tensor     # (N,) float32 degrees in [0, 360)
    level: torch.Tensor     # (N,) int64


def level_scales(n_levels: int = N_LEVELS):
    """float32 scale of each pyramid level (1.2f ** level, in float64)."""
    return [_F32(SCALE_FACTOR ** lv) for lv in range(n_levels)]


def level_size(H: int, W: int, scale: np.float32):
    """(H, W) of the level with this scale: round(size / scale) in float32,
    half to even."""
    inv = _F32(1.0) / scale
    return (int(np.rint(_F32(H) * inv)), int(np.rint(_F32(W) * inv)))


def features_per_level(n_features: int = N_FEATURES,
                       n_levels: int = N_LEVELS):
    """The geometric split of n_features over the levels, float32 as
    OpenCV computes it; the last level takes the remainder."""
    factor = _F32(1.0 / SCALE_FACTOR)
    nd = _F32(n_features) * (_F32(1) - factor) / (
        _F32(1) - _F32(float(factor) ** n_levels))
    out = []
    for _ in range(n_levels - 1):
        out.append(int(np.rint(nd)))
        nd = _F32(nd * factor)
    out.append(max(n_features - sum(out), 0))
    return out


def _umax(half: int = PATCH_SIZE // 2):
    """Half-width of each row of the radius-`half` disc (OpenCV's u_max,
    made symmetric in u and v)."""
    umax = [0] * (half + 2)
    vmax = int(math.floor(half * float(np.sqrt(_F32(2))) / 2 + 1))
    vmin = int(math.ceil(half * float(np.sqrt(_F32(2))) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.rint(math.sqrt(half * half - v * v)))
    v0 = 0
    for v in range(half, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[:half + 1]


def to_gray(color) -> torch.Tensor:
    """(H, W, 3) RGB float in [0, 1] -> (H, W) int32 gray in 0..255, through
    uint8 as extract_orb's np.clip(color * 255, 0, 255).astype(uint8)."""
    c8 = torch.clamp(color.float() * 255.0, 0, 255).to(torch.uint8).int()
    return (c8[..., 0] * 19596 + c8[..., 1] * 38470 + c8[..., 2] * 7470
            + (1 << 15)) >> 16


def _resize_taps(src: int, dst: int, device):
    """Source indices and 8-bit weights of the bit-exact bilinear resize
    along one axis (float64 coordinates, weights rounded half to even;
    outside the source the edge pixel, weight 256)."""
    scale = 1.0 / (np.float64(dst) / np.float64(src))
    f = scale * (np.arange(dst, dtype=np.float64) + 0.5) - 0.5
    i = np.floor(f).astype(np.int64)
    c1 = np.rint((f - i) * 256).astype(np.int64)
    edge = (i < 0) | (i >= src - 1)
    i0 = np.where(i < 0, 0, np.where(i >= src - 1, src - 1, i))
    i1 = np.minimum(i0 + 1, src - 1)
    c1 = np.where(edge, 0, c1)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return t(i0), t(i1), t(256 - c1).int(), t(c1).int()


def resize_linear_exact(img: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """cv2.resize(img, (W, H), interpolation=INTER_LINEAR_EXACT) of an
    int32 image of 0..255: horizontal taps in 8.8 fixed point, vertical
    taps on those, rounded half up from 16 fraction bits."""
    x0, x1, a0, a1 = _resize_taps(img.shape[1], W, img.device)
    y0, y1, b0, b1 = _resize_taps(img.shape[0], H, img.device)
    h = img[:, x0] * a0 + img[:, x1] * a1
    v = h[y0] * b0[:, None] + h[y1] * b1[:, None]
    return (v + (1 << 15)) >> 16


def _reflect101(n: int, r: int, device) -> torch.Tensor:
    i = torch.arange(-r, n + r, device=device).abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _fma32(a, b, c):
    """float32 fused multiply-add a*b + c, rounded once (through float64,
    where the product of two float32 values is exact)."""
    return (a.double() * b + c.double()).float()


def gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    """The 7x7, sigma 2 Gaussian of an int32 0..255 image as ORB blurs each
    level (cv2.sepFilter2D with the float32 kernel, reflect-101 border):
    the row pass accumulates the 7 taps left to right by fused
    multiply-adds, the column pass starts at the center row and adds the
    symmetric row pairs (summed in float32); rounded half to even."""
    H, W = img.shape
    dev = img.device
    ry, rx = _reflect101(H, 3, dev), _reflect101(W, 3, dev)
    p = img[ry][:, rx].double()                       # (H+6, W+6)
    k = [float(v) for v in _GAUSS7]
    s = torch.zeros((H + 6, W), dtype=torch.float32, device=dev)
    for i in range(7):
        s = _fma32(p[:, i:i + W], k[i], s)
    col = (s[3:3 + H].double() * k[3]).float()
    for j in (1, 2, 3):
        pair = s[3 - j:3 - j + H] + s[3 + j:3 + j + H]
        col = _fma32(pair, k[3 + j], col)
    return torch.clamp(torch.round(col), 0, 255).int()


def fast_scores(img: torch.Tensor, threshold: int = FAST_THRESHOLD):
    """FAST-9 corner scores (0 where no corner) over pixels at least 3 from
    the border: a corner has 9 contiguous circle pixels all darker than
    v - t or all brighter than v + t; its score is the largest such
    contrast over the 16 arcs, less one (OpenCV's cornerScore<16>)."""
    H, W = img.shape
    c = img[3:H - 3, 3:W - 3]
    ring = torch.stack([img[3 + dy:H - 3 + dy, 3 + dx:W - 3 + dx]
                        for dx, dy in _CIRCLE])
    d = c[None] - ring

    def best_arc(x):
        m2 = torch.minimum(x, torch.roll(x, -1, 0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, 0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, 0))
        return torch.minimum(m8, torch.roll(x, -8, 0)).amax(0)

    dark, bright = best_arc(d), best_arc(-d)
    corner = (dark > threshold) | (bright > threshold)
    score = torch.maximum(torch.maximum(dark, bright),
                          torch.full_like(dark, threshold)) - 1
    out = torch.zeros_like(img)
    out[3:H - 3, 3:W - 3] = torch.where(corner, score, 0)
    return out


def _nonmax(score: torch.Tensor) -> torch.Tensor:
    """Corners whose score beats all 8 neighbours strictly."""
    p = torch.nn.functional.pad(score, (1, 1, 1, 1))
    H, W = score.shape
    nb = torch.stack([p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                      if dy or dx]).amax(0)
    return (score > 0) & (score > nb)


def _retain_best(resp: torch.Tensor, n: int) -> torch.Tensor:
    """Mask of the n largest responses, every tie at the cut kept
    (KeyPointsFilter::retainBest)."""
    if resp.numel() <= n:
        return torch.ones_like(resp, dtype=torch.bool)
    if n == 0:
        return torch.zeros_like(resp, dtype=torch.bool)
    cut = torch.topk(resp, n).values[-1]
    return resp >= cut


def _patches(img: torch.Tensor, ys, xs, r: int) -> torch.Tensor:
    """(N, 2r+1, 2r+1) windows of img centered on (ys, xs)."""
    o = torch.arange(-r, r + 1, device=img.device)
    return img[(ys[:, None] + o)[:, :, None], (xs[:, None] + o)[:, None, :]]


def harris_response(img: torch.Tensor, ys, xs) -> torch.Tensor:
    """OpenCV's ORB Harris response at integer keypoints: 3x3 Sobel-like
    derivatives summed over a 7x7 block in int32, the response in float32
    in OpenCV's order of operations."""
    P = _patches(img, ys, xs, HARRIS_BLOCK // 2 + 1)
    Ix = ((P[:, 1:8, 2:9] - P[:, 1:8, 0:7]) * 2
          + (P[:, 0:7, 2:9] - P[:, 0:7, 0:7])
          + (P[:, 2:9, 2:9] - P[:, 2:9, 0:7]))
    Iy = ((P[:, 2:9, 1:8] - P[:, 0:7, 1:8]) * 2
          + (P[:, 2:9, 0:7] - P[:, 0:7, 0:7])
          + (P[:, 2:9, 2:9] - P[:, 0:7, 2:9]))
    a = (Ix * Ix).sum((1, 2)).float()
    b = (Iy * Iy).sum((1, 2)).float()
    c = (Ix * Iy).sum((1, 2)).float()
    scale = _F32(1.0) / (_F32(4 * HARRIS_BLOCK) * _F32(255.0))
    s4 = float(scale * scale * scale * scale)
    ab = a + b
    return ((a * b - c * c) - (float(HARRIS_K) * ab) * ab) * s4


def fast_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OpenCV's fastAtan2 (float32 polynomial, degrees in [0, 360))."""
    ax, ay = x.abs(), y.abs()
    p1, p3, p5, p7 = (float(v) for v in _ATAN_P)
    eps = float(_DBL_EPS_F32)
    wide = ax >= ay
    c = torch.where(wide, ay / (ax + eps), ax / (ay + eps))
    c2 = c * c
    a = (((c2 * p7 + p5) * c2 + p3) * c2 + p1) * c
    a = torch.where(wide, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def ic_angle(img: torch.Tensor, ys, xs) -> torch.Tensor:
    """Intensity-centroid orientation over the radius-15 disc, degrees."""
    half = PATCH_SIZE // 2
    umax = _umax(half)
    o = np.arange(-half, half + 1)
    mask = np.abs(o)[None, :] <= np.array(umax)[np.abs(o)][:, None]
    dev = img.device
    P = _patches(img, ys, xs, half)
    mu = torch.as_tensor(np.where(mask, o[None, :], 0), device=dev)
    mv = torch.as_tensor(np.where(mask, o[:, None], 0), device=dev)
    m10 = (P * mu).sum((1, 2)).float()
    m01 = (P * mv).sum((1, 2)).float()
    return fast_atan2_deg(m01, m10)


_PATTERN_CACHE = {}


def _pattern(device):
    key = str(device)
    if key not in _PATTERN_CACHE:
        pts = torch.tensor(PATTERN_31, dtype=torch.float32).reshape(512, 2)
        _PATTERN_CACHE[key] = (pts[:, 0].to(device), pts[:, 1].to(device))
    return _PATTERN_CACHE[key]


def describe(blurred: torch.Tensor, cy, cx, angle) -> torch.Tensor:
    """(N, 32) uint8 steered-BRIEF descriptors at integer centers of one
    blurred level: each pattern offset rotated by the angle in float32,
    rounded half to even; bit = first value < second value."""
    px, py = _pattern(blurred.device)
    ang = angle.float() * float(_F32(math.pi / 180.0))
    a = torch.cos(ang.double()).float()[:, None]
    b = torch.sin(ang.double()).float()[:, None]
    x = px * a - py * b
    y = px * b + py * a
    ix = torch.round(x).long() + cx[:, None]
    iy = torch.round(y).long() + cy[:, None]
    v = blurred[iy, ix]
    bits = (v[:, 0::2] < v[:, 1::2]).reshape(-1, 32, 8).to(torch.int32)
    weights = 1 << torch.arange(8, device=blurred.device, dtype=torch.int32)
    return (bits * weights).sum(-1).to(torch.uint8)


def pyramid(gray: torch.Tensor, n_levels: int = N_LEVELS):
    """The unblurred levels: level 0 is the image, each next one the exact
    bilinear resize of the level above."""
    H, W = gray.shape
    levels = [gray]
    for s in level_scales(n_levels)[1:]:
        levels.append(resize_linear_exact(levels[-1], *level_size(H, W, s)))
    return levels


def detect_and_compute(gray: torch.Tensor):
    """ORB keypoints and descriptors of an int32 gray image.
    Returns (Keypoints, (N, 32) uint8 tensor)."""
    dev = gray.device
    scales = level_scales()
    quota = features_per_level()
    b = EDGE_THRESHOLD
    kx, ky, ka, kl, des = [], [], [], [], []
    for lv, img in enumerate(pyramid(gray)):
        H, W = img.shape
        if H <= 2 * b or W <= 2 * b:
            continue
        score = fast_scores(img)
        keep = _nonmax(score)
        keep[:b] = False
        keep[H - b:] = False
        keep[:, :b] = False
        keep[:, W - b:] = False
        ys, xs = torch.nonzero(keep, as_tuple=True)   # row-major order
        sel = _retain_best(score[ys, xs], 2 * quota[lv])
        ys, xs = ys[sel], xs[sel]
        resp = harris_response(img, ys, xs)
        sel = _retain_best(resp, quota[lv])
        ys, xs = ys[sel], xs[sel]
        if ys.numel() == 0:
            continue
        ang = ic_angle(img, ys, xs)
        des.append(describe(gaussian_blur(img), ys, xs, ang))
        s = float(scales[lv])
        kx.append(xs.float() * s)
        ky.append(ys.float() * s)
        ka.append(ang)
        kl.append(torch.full_like(ys, lv))
    if not des:
        z = torch.zeros(0, device=dev)
        return (Keypoints(z, z, z, z.long()),
                torch.zeros((0, 32), dtype=torch.uint8, device=dev))
    cat = torch.cat
    return Keypoints(cat(kx), cat(ky), cat(ka), cat(kl)), cat(des)


def compute_at(gray: torch.Tensor, x, y, angle, level) -> torch.Tensor:
    """Descriptors at keypoints passed in (level-0 coordinates, degrees,
    pyramid level), as ORB.compute makes them: the center is the
    keypoint's position in its level, rounded. Keypoints closer than 31 px
    to the image border must be left out by the caller, as OpenCV drops
    them."""
    x, y = torch.as_tensor(x, dtype=torch.float32, device=gray.device), \
        torch.as_tensor(y, dtype=torch.float32, device=gray.device)
    angle = torch.as_tensor(angle, dtype=torch.float32, device=gray.device)
    level = torch.as_tensor(level, device=gray.device).long()
    n_lv = int(level.max()) + 1 if level.numel() else 1
    levels = pyramid(gray, n_lv)
    out = torch.zeros((x.shape[0], 32), dtype=torch.uint8, device=gray.device)
    for lv, s in enumerate(level_scales(n_lv)):
        m = level == lv
        if not bool(m.any()):
            continue
        inv = float(_F32(1.0) / s)
        cx = torch.round(x[m] * inv).long()
        cy = torch.round(y[m] * inv).long()
        out[m] = describe(gaussian_blur(levels[lv]), cy, cx, angle[m])
    return out


def extract_orb(color, device=None) -> Optional[np.ndarray]:
    """ORB descriptors of an RGB float image in [0, 1] (cv2.ORB_create
    defaults), computed on `device` (the card unless the caller names
    another; a torch tensor's own device when color is one). Returns
    (N, 32) uint8 numpy, or None when no keypoint is found."""
    if isinstance(color, torch.Tensor):
        dev = color.device if device is None else torch.device(device)
        c = color.to(dev)
    else:
        from .. import resolve_device

        dev = resolve_device(device)
        c = torch.as_tensor(np.asarray(color, np.float32), device=dev)
    _, des = detect_and_compute(to_gray(c))
    if des.shape[0] == 0:
        return None
    return des.cpu().numpy()
