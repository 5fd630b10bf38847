"""Render-vs-ground-truth residual panels (port of
loopy_slam_tpu/utils/visualizer.py).

`Visualizer.vis` renders the frame through the current map and writes one
image of six panels, as the JAX package's figure holds them:

    input depth | rendered depth | depth residual
    input rgb   | rendered rgb   | rgb residual

with the same value ranges (depth panels 0..max input depth, the depth
residual 0..0.2 of it, the rgb residual 0..0.5) and the same gating
(idx > 0 and idx % freq == 0). The JAX package draws the figure with
matplotlib and saves a JPEG; the card's machine has no matplotlib (and no
JPEG encoder), so the port tiles the panels in numpy, maps the scalar
panels through a plasma-like colormap table, and writes a PNG with the
standard library (zlib, struct). The `.png` name is the only difference
in what is written; the panel titles of the figure are left out.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

# plasma anchors (position, r, g, b), linearly interpolated to 256 entries
_PLASMA_ANCHORS = np.array([
    [0.000, 0.050, 0.030, 0.528],
    [0.125, 0.255, 0.014, 0.615],
    [0.250, 0.418, 0.001, 0.658],
    [0.375, 0.563, 0.052, 0.642],
    [0.500, 0.693, 0.165, 0.565],
    [0.625, 0.798, 0.280, 0.470],
    [0.750, 0.881, 0.393, 0.383],
    [0.875, 0.949, 0.518, 0.296],
    [0.9375, 0.988, 0.652, 0.211],
    [1.000, 0.940, 0.975, 0.131],
])
_LUT = np.stack([np.interp(np.linspace(0, 1, 256), _PLASMA_ANCHORS[:, 0],
                           _PLASMA_ANCHORS[:, c]) for c in (1, 2, 3)], -1)


def colormap(img: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """(H, W) scalars -> (H, W, 3) float RGB in [0, 1] through the table,
    clipped to [vmin, vmax]."""
    t = (np.asarray(img, np.float64) - vmin) / max(vmax - vmin, 1e-12)
    return _LUT[np.clip(np.rint(t * 255), 0, 255).astype(np.int64)]


def six_panels(gt_depth, depth, gt_color, color) -> np.ndarray:
    """The six panels tiled 2 x 3 as uint8 (2H, 3W, 3)."""
    gt_depth = np.asarray(gt_depth, np.float64)
    depth = np.asarray(depth, np.float64)
    gt_color = np.asarray(gt_color, np.float64)
    color = np.asarray(color, np.float64)
    valid = gt_depth > 0
    depth_residual = np.abs(gt_depth - depth) * valid
    color_residual = np.abs(gt_color - color).mean(-1) * valid
    vmax = max(float(gt_depth.max()), 1e-6)
    top = [colormap(gt_depth, 0, vmax), colormap(depth, 0, vmax),
           colormap(depth_residual, 0, vmax * 0.2)]
    bottom = [np.clip(gt_color, 0, 1), np.clip(color, 0, 1),
              colormap(color_residual, 0, 0.5)]
    tiled = np.concatenate([np.concatenate(top, 1),
                            np.concatenate(bottom, 1)], 0)
    return np.clip(np.rint(tiled * 255), 0, 255).astype(np.uint8)


def write_png(path: str, rgb: np.ndarray) -> None:
    """8-bit RGB PNG of an (H, W, 3) uint8 array (no filtering)."""
    H, W, _ = rgb.shape
    raw = np.concatenate([np.zeros((H, 1), np.uint8),
                          np.ascontiguousarray(rgb, np.uint8).reshape(H, -1)],
                         1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


class Visualizer:
    def __init__(self, freq: int, vis_dir: str, slam, verbose=True):
        self.freq = max(int(freq), 1)
        self.vis_dir = vis_dir
        self.slam = slam
        self.verbose = verbose
        os.makedirs(vis_dir, exist_ok=True)

    def vis(self, idx: int, iter_: int, gt_depth, gt_color, c2w,
            freq_override: bool = False, save_rendered_image: bool = False):
        """Render frame idx at c2w and write <idx>_<iter>.png; returns
        (depth, color), or None when the gate does not fire."""
        if not freq_override and (idx == 0 or idx % self.freq != 0):
            return None
        depth, color = self.slam.render_img(c2w, gt_depth)
        path = os.path.join(self.vis_dir, f"{idx:05d}_{iter_:04d}.png")
        write_png(path, six_panels(gt_depth, depth, gt_color, color))
        if save_rendered_image:
            np.save(os.path.join(self.vis_dir, f"color_{idx:05d}.npy"),
                    np.clip(color, 0, 1))
            np.save(os.path.join(self.vis_dir, f"depth_{idx:05d}.npy"),
                    depth)
        if self.verbose:
            print(f"saved visualization {path}")
        return depth, color
