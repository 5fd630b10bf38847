"""Render-vs-ground-truth residual panels (port of
loopy_slam_tpu/utils/visualizer.py).

`Visualizer.vis_value_only` renders a frame through the current map and
returns (depth, color); `Visualizer.vis` renders it so and writes one image
of six panels, as the JAX package's figure holds them:

    input depth | rendered depth | depth residual
    input rgb   | rendered rgb   | rgb residual

with the same value ranges (depth panels 0..max input depth, the depth
residual 0..0.2 of it, the rgb residual 0..0.5), the same gating (idx > 0
and idx % freq == 0) and the same file name, <idx:05d>_<iter:04d>.jpg. The
JAX package draws the figure with matplotlib; the card's machine has no
matplotlib, so the port tiles the panels in numpy, maps the scalar panels
through a plasma-like colormap table, and writes a baseline JPEG with the
port's own encoder (utils/imageio.write_jpeg, quality JPEG_QUALITY). The
figure's panel titles and margins are left out.
"""

from __future__ import annotations

import os

import numpy as np

from .imageio import write_jpeg

# the panels' JPEG quality (write_jpeg's scale of the standard tables)
JPEG_QUALITY = 95

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


class Visualizer:
    def __init__(self, freq: int, vis_dir: str, slam, verbose=True):
        self.freq = max(int(freq), 1)
        self.vis_dir = vis_dir
        self.slam = slam
        self.verbose = verbose
        os.makedirs(vis_dir, exist_ok=True)

    def vis_value_only(self, c2w, gt_depth, r_query_map=None):
        """Full-frame render through the current map (no image): numpy
        (depth (H, W), color (H, W, 3)), as slam.render_img returns them."""
        return self.slam.render_img(c2w, gt_depth, r_query_map=r_query_map)

    def vis(self, idx: int, iter_: int, gt_depth, gt_color, c2w,
            r_query_map=None, freq_override: bool = False,
            save_rendered_image: bool = False):
        """Render frame idx at c2w (with the frame's query-radius map,
        if the session has one) and write <idx>_<iter>.jpg; returns
        (depth, color), or None when the gate does not fire."""
        if not freq_override and (idx == 0 or idx % self.freq != 0):
            return None
        depth, color = self.vis_value_only(c2w, gt_depth,
                                           r_query_map=r_query_map)
        path = os.path.join(self.vis_dir, f"{idx:05d}_{iter_:04d}.jpg")
        write_jpeg(path, six_panels(gt_depth, depth, gt_color, color),
                   JPEG_QUALITY)
        if save_rendered_image:
            np.save(os.path.join(self.vis_dir, f"color_{idx:05d}.npy"),
                    np.clip(color, 0, 1))
            np.save(os.path.join(self.vis_dir, f"depth_{idx:05d}.npy"),
                    depth)
        if self.verbose:
            print(f"saved visualization {path}")
        return depth, color
