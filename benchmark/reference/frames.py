"""The frames that the loaders should hand the program, worked out again
from what the benchmark wrote: the scene rendered at the frame's pose, the
sensor's draws of the mix (TUM: dropped depth frames, zero-depth holes,
stamps), the depth's 16-bit quantization, and for a distorted camera the
undistortion of the written image. Nothing is read back through a decoder.

For frame `idx` of the program's sequence (TUM frames are associated by
timestamp and thinned to 32 a second, as the dataset's own tools do):

  depth(idx, i, j)  the written depth in meters at pixel column i, row j of
                    the cropped frame (the 16-bit value over the scale);
  color(idx, i, j)  the colour in levels 0..255: the pixels the JPEG was
                    made from (Replica), or the written distorted image
                    undistorted by bilinear sampling in float64 under a
                    constant 0 border (TUM);
  with `shift` the frame `shift` frames earlier (the control).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from bench_core.scene import Scene
from bench_core.sequence import _tum_plan, apply_holes, distort_image


def associate(plan: List[Dict], max_dt: float = 0.08,
              frame_rate: float = 32.0) -> List[Tuple[int, int]]:
    """(colour frame, depth frame) of each frame of the sequence: the depth
    stamp nearest each colour stamp within max_dt, then every frame more
    than 1 / frame_rate after the last one kept. Stamps as written, to the
    microsecond."""
    t_img = np.array([float(f"{e['t']:.6f}") for e in plan])
    kept = [n for n, e in enumerate(plan) if e["depth_name"] is not None]
    t_dep = np.array([float(f"{plan[n]['td']:.6f}") for n in kept])
    pairs = []
    for a, t in enumerate(t_img):
        b = int(np.argmin(np.abs(t_dep - t)))
        if abs(t_dep[b] - t) < max_dt:
            pairs.append((a, kept[b]))
    out = [pairs[0]]
    for a, b in pairs[1:]:
        if t_img[a] - t_img[out[-1][0]] > 1.0 / frame_rate:
            out.append((a, b))
    return out


class Recording:
    """One recording of a traffic mix, as the benchmark wrote it."""

    def __init__(self, fmt: str, cam: Dict, traffic: Dict, which: int):
        seq = traffic["sequences"][which]
        frames = int(traffic["frames"])
        self.fmt, self.cam = fmt, cam
        self.scene = Scene(cam, float(traffic["motion_speed"]),
                           float(seq["phase"]), traffic.get("scene", "v2"))
        self.edge = int(cam.get("crop_edge", 0))
        self.scale = cam["png_depth_scale"]
        self._renders: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.plan = None
        if fmt == "tumrgbd":
            self.plan, _ = _tum_plan(
                self.scene, cam, frames,
                np.random.default_rng(int(seq["sensor_seed"])),
                traffic.get("sensor") or {})
            self.pairs = associate(self.plan)
        elif fmt == "replica":
            self.pairs = [(n, n) for n in range(frames)]
        else:
            raise ValueError(f"no reference frames for format {fmt!r}")

    def _render(self, n: int):
        if n not in self._renders:
            self._renders[n] = self.scene.render_frame(self.scene.pose(n))
        return self._renders[n]

    def _rows_cols(self, i, j):
        return (np.asarray(j, np.int64) + self.edge,
                np.asarray(i, np.int64) + self.edge)

    def depth(self, idx: int, i, j, shift: int = 0) -> np.ndarray:
        b = self.pairs[idx - shift][1]
        d = self._render(b)[1]
        if self.plan is not None:
            d = apply_holes(d, self.plan[b]["holes"])
        d16 = np.clip(d * self.scale, 0, 65535).astype(np.uint16)
        r, c = self._rows_cols(i, j)
        return d16[r, c].astype(np.float64) / self.scale

    def color(self, idx: int, i, j, shift: int = 0) -> np.ndarray:
        a = self.pairs[idx - shift][0]
        rgb8 = (self._render(a)[0] * 255.0).round().astype(np.uint8)
        r, c = self._rows_cols(i, j)
        if self.fmt == "replica":
            return rgb8[r, c].astype(np.float64)
        cam = self.cam
        K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]],
                      [0, 0, 1]], np.float64)
        img = distort_image(rgb8, K, cam["distortion"]).astype(np.float64)
        u, v = self._distorted(c.astype(np.float64), r.astype(np.float64))
        u0, v0 = np.floor(u), np.floor(v)
        au, av = (u - u0)[:, None], (v - v0)[:, None]
        u0, v0 = u0.astype(np.int64), v0.astype(np.int64)
        top = _tap(img, v0, u0) * (1 - au) + _tap(img, v0, u0 + 1) * au
        bot = _tap(img, v0 + 1, u0) * (1 - au) + _tap(img, v0 + 1, u0 + 1) * au
        return top * (1 - av) + bot * av

    def _distorted(self, u, v):
        """Where undistorted pixel (u, v) lies in the distorted image: the
        Brown-Conrady model with the camera's (k1, k2, p1, p2, k3)."""
        cam = self.cam
        k = np.zeros(5)
        dist = np.asarray(cam["distortion"], np.float64).reshape(-1)
        k[:dist.size] = dist
        k1, k2, p1, p2, k3 = k
        x = (u - cam["cx"]) / cam["fx"]
        y = (v - cam["cy"]) / cam["fy"]
        r2 = x * x + y * y
        radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return xd * cam["fx"] + cam["cx"], yd * cam["fy"] + cam["cy"]


def _tap(img, rows, cols):
    """img[rows, cols], 0 outside the image."""
    H, W = img.shape[:2]
    ok = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
    out = img[np.clip(rows, 0, H - 1), np.clip(cols, 0, W - 1)]
    return out * ok[:, None]
