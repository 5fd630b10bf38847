"""Dense TSDF fusion + surface extraction (marching tetrahedra).

Port of loopy_slam_tpu/ops/tsdf.py: the per-submap registration clouds of
loop closure are the vertices of a mesh fused from the segment's frames
(voxel 5/512 or larger, trunc 0.04). Everything runs on the grid's
device: `integrate` is one gather and elementwise pass over the dense
grid per frame (7.1M voxels at the fixed 192^3, about 142 MB of tsdf,
weight and color in float32), and `extract_mesh` runs the JAX package's
numpy marching tetrahedra in torch, float64 positions, on only the cubes
whose corners change sign.

Conventions: poses are in the dataset's OpenGL convention; `integrate`
flips them to the CV pinhole (+z forward) with diag(1, -1, -1, 1), as the
reference re-flips before integration.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import resolve_device


class TSDFGrid(NamedTuple):
    tsdf: torch.Tensor     # (X, Y, Z) float32, init +1
    weight: torch.Tensor   # (X, Y, Z) float32
    color: torch.Tensor    # (X, Y, Z, 3) float32
    origin: torch.Tensor   # (3,) float32 world position of voxel (0,0,0)
    voxel: torch.Tensor    # () float32


def init_grid(origin, dims: Tuple[int, int, int], voxel: float,
              device=None) -> TSDFGrid:
    X, Y, Z = dims
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    return TSDFGrid(
        tsdf=torch.ones((X, Y, Z), **f32),
        weight=torch.zeros((X, Y, Z), **f32),
        color=torch.zeros((X, Y, Z, 3), **f32),
        origin=torch.as_tensor(np.asarray(origin, np.float32), **f32),
        voxel=torch.tensor(voxel, **f32),
    )


def grid_for_bounds(lo, hi, voxel: float, fixed_dims=None,
                    device=None) -> TSDFGrid:
    """fixed_dims pins the grid SHAPE (the voxel adapts to the bounds
    instead), as the JAX package does so that its integrate compiles once;
    the port keeps it so both packages fuse the same grid."""
    lo = np.asarray(lo, np.float64) - 2 * voxel
    hi = np.asarray(hi, np.float64) + 2 * voxel
    if fixed_dims is not None:
        voxel = max(voxel, float(np.max((hi - lo) / (np.array(fixed_dims)
                                                     - 1))))
        return init_grid(lo, tuple(fixed_dims), voxel, device)
    dims = tuple(int(d) for d in np.ceil((hi - lo) / voxel) + 1)
    return init_grid(lo, dims, voxel, device)


def voxel_centers(grid: TSDFGrid) -> torch.Tensor:
    """(X*Y*Z, 3) float32 world positions of the grid's voxels, C order."""
    X, Y, Z = grid.tsdf.shape
    dev = grid.tsdf.device
    ii, jj, kk = torch.meshgrid(torch.arange(X, device=dev),
                                torch.arange(Y, device=dev),
                                torch.arange(Z, device=dev), indexing="ij")
    return (torch.stack([ii, jj, kk], -1).reshape(-1, 3).float()
            * grid.voxel + grid.origin)


@torch.no_grad()
def integrate(grid: TSDFGrid, depth, color, c2w, fx: float, fy: float,
              cx: float, cy: float, trunc: float = 0.04,
              depth_trunc: float = 30.0, pts=None) -> TSDFGrid:
    """Fuse one RGBD frame. depth (H, W) meters, color (H, W, 3) in [0, 1],
    c2w 4x4 in the dataset's OpenGL convention (tensors on the grid's
    device). pts: voxel_centers(grid), when the caller keeps it across
    frames."""
    H, W = depth.shape
    X, Y, Z = grid.tsdf.shape
    dev = grid.tsdf.device
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0], device=dev))
    w2c = torch.linalg.inv(c2w.float() @ flip)
    if pts is None:
        pts = voxel_centers(grid)
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    zc = torch.clamp(z, min=1e-6)
    u = fx * cam[:, 0] / zc + cx
    v = fy * cam[:, 1] / zc + cy
    ui = torch.round(u).to(torch.int32)     # half to even, like jnp.round
    vi = torch.round(v).to(torch.int32)
    inb = (z > 0) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    pix = (torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)).long()
    d = depth.reshape(-1)[pix]
    sdf = d - z
    valid = inb & (d > 0) & (d < depth_trunc) & (sdf > -trunc)
    tsdf_new = torch.clamp(sdf / trunc, -1.0, 1.0)

    w_old = grid.weight.reshape(-1)
    w_sum = w_old + valid.float()
    den = torch.clamp(w_sum, min=1e-6)
    t_old = grid.tsdf.reshape(-1)
    t = torch.where(valid, (t_old * w_old + tsdf_new) / den, t_old)
    c_old = grid.color.reshape(-1, 3)
    rgb = color.reshape(-1, 3)[pix]
    c = torch.where(valid[:, None],
                    (c_old * w_old[:, None] + rgb) / den[:, None], c_old)
    return TSDFGrid(tsdf=t.reshape(X, Y, Z), weight=w_sum.reshape(X, Y, Z),
                    color=c.reshape(X, Y, Z, 3), origin=grid.origin,
                    voxel=grid.voxel)


# 6-tetrahedra decomposition of the unit cube (corner c = x*4 + y*2 + z)
_TETS = ((0, 5, 1, 3), (0, 5, 3, 7), (0, 5, 7, 4),
         (0, 7, 3, 2), (0, 7, 2, 6), (0, 7, 6, 4))
_CORNERS = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                     for z in (0, 1)])


def _empty_mesh():
    return (np.zeros((0, 3)), np.zeros((0, 3), np.int64), np.zeros((0, 3)))


@torch.no_grad()
def extract_mesh(grid: TSDFGrid, min_weight: float = 0.0):
    """Marching tetrahedra over the fused grid -> numpy (verts, faces,
    colors). Voxels with weight <= min_weight are unobserved and poison
    their cubes, so unseen space produces no surface; inside is v < 0,
    outside v >= 0. Triangles come in the JAX package's order (tet, then
    inside-corner code, then cube)."""
    vol = torch.where(grid.weight > min_weight, grid.tsdf,
                      torch.full((), float("nan"), device=grid.tsdf.device))
    X, Y, Z = vol.shape
    if min(X, Y, Z) < 2:
        return _empty_mesh()
    corners = [vol[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
               for dx, dy, dz in _CORNERS]
    fin = lo = hi = None
    for c in corners:
        f = torch.isfinite(c)
        fin = f if fin is None else fin & f
        lo = c if lo is None else torch.minimum(lo, c)
        hi = c if hi is None else torch.maximum(hi, c)
    mixed = fin & (lo < 0) & (hi >= 0)
    base = torch.nonzero(mixed)                      # (M, 3), C order
    if base.shape[0] == 0:
        return _empty_mesh()
    cv = torch.stack([c[mixed] for c in corners], 1)  # (M, 8) float32
    base = base.double()
    corner_off = torch.as_tensor(_CORNERS, dtype=torch.float64,
                                 device=vol.device)
    tris = []
    bits = torch.tensor([1, 2, 4, 8], device=vol.device)
    for tet in _TETS:
        vals = cv[:, list(tet)]                          # (M, 4)
        pos = base[:, None, :] + corner_off[list(tet)][None]   # (M, 4, 3)
        code = ((vals < 0).long() * bits).sum(1)

        def edge_pt(m, a, b):
            va, vb = vals[m, a], vals[m, b]
            t = va / (va - vb + 1e-12)                   # float32, as numpy
            return pos[m, a] + t.double()[:, None] * (pos[m, b] - pos[m, a])

        for cs in range(1, 15):
            m = code == cs
            if not bool(m.any()):
                continue
            ins = [i for i in range(4) if cs & (1 << i)]
            outs = [i for i in range(4) if not cs & (1 << i)]
            if len(ins) == 1:
                a = ins[0]
                tris.append(torch.stack([edge_pt(m, a, o) for o in outs], 1))
            elif len(ins) == 3:
                a = outs[0]
                tris.append(torch.stack([edge_pt(m, i, a) for i in ins], 1))
            else:
                a, b = ins
                c, d = outs
                p_ac, p_ad = edge_pt(m, a, c), edge_pt(m, a, d)
                p_bc, p_bd = edge_pt(m, b, c), edge_pt(m, b, d)
                tris.append(torch.stack([p_ac, p_ad, p_bd], 1))
                tris.append(torch.stack([p_ac, p_bd, p_bc], 1))
    return _weld(torch.cat(tris, 0), grid.color, grid.origin, grid.voxel)


def _weld(tris, colg, origin, voxel):
    """Weld a (T, 3, 3) voxel-coordinate triangle soup into an indexed mesh
    with vertex colors (duplicates merged on 1e-4-voxel keys)."""
    flat = tris.reshape(-1, 3)
    # the three 1e-4-voxel keys (>= 0, < 2^21 on grids up to 209 voxels)
    # packed into one int64, so the unique vertices come in the
    # lexicographic order of np.unique(axis=0)
    k = torch.round(flat / 1e-4).long()
    key = (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]
    uniq, inv = torch.unique(key, return_inverse=True)
    n = uniq.shape[0]
    verts_vox = torch.zeros((n, 3), dtype=torch.float64,
                            device=flat.device).index_add_(0, inv, flat)
    counts = torch.bincount(inv, minlength=n).double()
    verts_vox = verts_vox / counts[:, None]
    faces = inv.reshape(-1, 3)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    faces = faces[good]
    verts = verts_vox * voxel.double() + origin.double()
    colors = _trilinear_color(colg, verts_vox)
    return (verts.cpu().numpy(), faces.cpu().numpy(),
            colors.cpu().numpy())


def _trilinear_color(colg: torch.Tensor, vox: torch.Tensor) -> torch.Tensor:
    X, Y, Z, _ = colg.shape
    hi = torch.tensor([X - 1.001, Y - 1.001, Z - 1.001], dtype=torch.float64,
                      device=vox.device)
    p = torch.minimum(torch.clamp(vox, min=0), hi)
    i0 = torch.floor(p).long()
    f = p - i0
    out = torch.zeros((p.shape[0], 3), dtype=torch.float64, device=p.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((1 - dx - f[:, 0]).abs() * (1 - dy - f[:, 1]).abs()
                     * (1 - dz - f[:, 2]).abs())
                out += w[:, None] * colg[
                    torch.clamp(i0[:, 0] + dx, max=X - 1),
                    torch.clamp(i0[:, 1] + dy, max=Y - 1),
                    torch.clamp(i0[:, 2] + dz, max=Z - 1)].double()
    return torch.clamp(out, 0, 1)


def fuse_frames(frames, c2ws, fx, fy, cx, cy, voxel=0.02, trunc=0.04,
                bounds=None, depth_trunc=30.0, fixed_dims=None,
                device=None) -> TSDFGrid:
    """Fuse a list of (color, depth) numpy frames with their c2w poses on
    `device` (the card unless the caller asks for the CPU). bounds=None
    derives them from unprojected depth samples."""
    device = resolve_device(device)
    if bounds is None:
        pts_all = []
        for (color, depth), c2w in zip(frames, c2ws):
            H, W = depth.shape
            step = max(1, H * W // 5000)
            jj, ii = np.unravel_index(np.arange(0, H * W, step), (H, W))
            d = depth[jj, ii]
            ok = d > 0
            dirs = np.stack([(ii - cx) / fx, -(jj - cy) / fy,
                             -np.ones_like(d)], -1)
            pts = (dirs @ np.asarray(c2w)[:3, :3].T) * d[:, None] + \
                np.asarray(c2w)[:3, 3]
            pts_all.append(pts[ok])
        pts_all = np.concatenate(pts_all)
        bounds = (pts_all.min(0), pts_all.max(0))
    grid = grid_for_bounds(bounds[0], bounds[1], voxel,
                           fixed_dims=fixed_dims, device=device)
    trunc = max(trunc, 2.0 * float(grid.voxel))
    pts = voxel_centers(grid)
    for (color, depth), c2w in zip(frames, c2ws):
        t = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32), device=device)
        grid = integrate(grid, t(depth), t(color), t(c2w), float(fx),
                         float(fy), float(cx), float(cy), trunc=trunc,
                         depth_trunc=depth_trunc, pts=pts)
    return grid
