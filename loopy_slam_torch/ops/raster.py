"""Mesh depth images for the 2-D reconstruction metric.

Port of loopy_slam_tpu/ops/raster.py and of the JAX package's native
rasterizer wrapper (`native/build.py:raster_mesh_depth`):

  * `raster_mesh_depth`: z-buffer triangle rasterization on the host, by
    the port's copy of the C++ rasterizer (`csrc/raster_depth.cpp`, built
    with g++ at first use). It is the metric's only rasterizer: a failed
    build raises, where the JAX package falls back to the point splat.
  * `sample_mesh_surface` (numpy) and `render_depth_points`, a scatter-min
    z-buffer of surface samples in torch on the device.

Camera convention of the datasets: c2w looks down -z, depth along the
optical axis is -z_cam, u = fx x / -z + cx, v = -fy y / -z + cy.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera import invert_c2w


def sample_mesh_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                        rng=None, colors=None):
    """Area-weighted uniform samples on a triangle mesh (host)."""
    rng = rng or np.random.default_rng(0)
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    p = area / max(area.sum(), 1e-12)
    tri = rng.choice(len(faces), size=n, p=p)
    u = rng.uniform(size=(n, 1))
    v = rng.uniform(size=(n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    pts = v0[tri] + u * (v1[tri] - v0[tri]) + v * (v2[tri] - v0[tri])
    if colors is not None:
        c0, c1, c2 = (colors[faces[:, i]] for i in range(3))
        cols = (c0[tri] * (1 - u - v) + c1[tri] * u + c2[tri] * v)
        return pts, cols
    return pts, None


@torch.no_grad()
def render_depth_points(points: torch.Tensor, c2w: torch.Tensor, H: int,
                        W: int, fx: float, fy: float, cx: float,
                        cy: float) -> torch.Tensor:
    """(H, W) z-buffer depth image of surface samples (N, 3) seen from c2w,
    on their device; pixels no sample hits are 0."""
    w2c = invert_c2w(c2w)
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    z = -cam[:, 2]
    zs = torch.clamp(z, min=1e-6)
    u = fx * cam[:, 0] / zs + cx
    v = -fy * cam[:, 1] / zs + cy
    ui = torch.round(u).to(torch.int64)     # half to even, like jnp.round
    vi = torch.round(v).to(torch.int64)
    ok = (z > 1e-4) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    flat = torch.where(ok, vi * W + ui, torch.full_like(ui, H * W))
    inf = torch.full((), float("inf"), device=points.device)
    zb = torch.full((H * W + 1,), float("inf"), device=points.device)
    zb.scatter_reduce_(0, flat, torch.where(ok, z, inf), reduce="amin")
    depth = zb[:H * W].reshape(H, W)
    return torch.where(torch.isfinite(depth), depth,
                       torch.zeros((), device=points.device))


def raster_mesh_depth(verts, faces, c2w, H: int, W: int, fx: float,
                      fy: float, cx: float, cy: float) -> np.ndarray:
    """(H, W) float32 depth image of a triangle mesh from pose c2w, 0 where
    nothing is hit (perspective-correct depth, nearest triangle)."""
    from ..csrc.build import load_raster_library

    lib = load_raster_library()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    w2c = np.ascontiguousarray(np.linalg.inv(np.asarray(c2w, np.float64)))
    out = np.empty(H * W, np.float32)
    lib.raster_depth(verts.ctypes.data, len(verts), faces.ctypes.data,
                     len(faces), w2c.ctypes.data, H, W, float(fx), float(fy),
                     float(cx), float(cy), out.ctypes.data)
    return out.reshape(H, W)
