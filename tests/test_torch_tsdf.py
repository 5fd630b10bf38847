"""Parity of the port's TSDF fusion and marching tetrahedra with the JAX
package's, on the CPU.

Tolerances: integrate's tsdf, weight and color within 1e-5 (float32 on
both sides; the 4x4 inverse and the 3-term dot differ in rounding order);
extract_mesh, on the same fused grid, the same welded vertices, faces and
colors within 1e-6 voxel and 1e-5 (the same float32 edge weights, float64
positions). The JAX side runs its numpy marching tetrahedra (the native
C++ one is held equal to it by tests/test_native.py).
"""

import numpy as np
import pytest
import torch

from conftest import small_cfg
from loopy_slam_torch.ops import tsdf as tt
from loopy_slam_tpu.ops import tsdf as jt
from loopy_slam_tpu.utils.datasets import Synthetic


def _frames(n=4):
    cfg = small_cfg()
    ds = Synthetic(cfg)
    frames, poses = [], []
    for i in range(0, 2 * n, 2):
        _, c, d, p = ds[i]
        frames.append((c, d))
        poses.append(p)
    cam = tuple(cfg["cam"][k] for k in ("fx", "fy", "cx", "cy"))
    return frames, poses, cam


@pytest.fixture(scope="module")
def fused():
    frames, poses, cam = _frames()
    bounds = (np.array([-2.0, -1.5, -2.5]), np.array([2.0, 1.5, 1.0]))
    kw = dict(voxel=0.05, trunc=0.04, bounds=bounds, fixed_dims=(48, 48, 48))
    return (jt.fuse_frames(frames, poses, *cam, **kw),
            tt.fuse_frames(frames, poses, *cam, **kw, device="cpu"))


def test_integrate_matches_jax_on_a_48_grid(fused):
    jg, tg = fused
    for name in ("tsdf", "weight", "color", "origin", "voxel"):
        np.testing.assert_allclose(getattr(tg, name).numpy(),
                                   np.asarray(getattr(jg, name)), atol=1e-5,
                                   err_msg=name)
    assert float(tg.weight.sum()) > 1000  # the frames were seen


def test_extract_mesh_matches_jax_numpy_path(fused, monkeypatch):
    import loopy_slam_tpu.native.build as native

    monkeypatch.setattr(native, "march_tets_native", lambda vol: None)
    jg, _ = fused
    jv, jf, jc = jt.extract_mesh(jg)
    grid = tt.TSDFGrid(*(torch.as_tensor(np.array(a)) for a in jg))
    tv, tf, tc = tt.extract_mesh(grid)
    assert len(tv) == len(jv) > 500
    voxel = float(np.asarray(jg.voxel))
    assert np.abs(tv - jv).max() / voxel <= 1e-6
    np.testing.assert_allclose(tc, jc, atol=1e-5)
    np.testing.assert_array_equal(tf, jf)


def test_flat_wall_is_extracted_where_it_is():
    H, W = 60, 80
    depth = np.full((H, W), 2.0, np.float32)
    color = np.tile(np.array([0.2, 0.5, 0.8], np.float32), (H, W, 1))
    grid = tt.fuse_frames([(color, depth)], [np.eye(4, dtype=np.float32)],
                          60.0, 60.0, 39.5, 29.5, voxel=0.05, trunc=0.15,
                          device="cpu")
    verts, faces, colors = tt.extract_mesh(grid)
    assert len(verts) > 100 and len(faces) > 100
    assert np.abs(verts[:, 2] + 2.0).max() < 0.08  # the wall at z = -2
    np.testing.assert_allclose(colors.mean(0), [0.2, 0.5, 0.8], atol=0.05)
    assert faces.max() < len(verts)


def test_weights_accumulate_and_empty_grid_has_no_mesh():
    depth = torch.full((20, 20), 1.0)
    color = torch.zeros((20, 20, 3))
    grid = tt.grid_for_bounds([-1, -1, -2], [1, 1, 0], 0.1, device="cpu")
    verts, faces, _ = tt.extract_mesh(grid)  # nothing observed yet
    assert len(verts) == 0 and faces.shape == (0, 3)
    g1 = tt.integrate(grid, depth, color, torch.eye(4), 20.0, 20.0, 9.5, 9.5)
    g2 = tt.integrate(g1, depth, color, torch.eye(4), 20.0, 20.0, 9.5, 9.5)
    assert float(g2.weight.sum()) > 1.9 * float(g1.weight.sum()) > 0
