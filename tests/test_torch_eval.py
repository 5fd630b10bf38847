"""The port's evaluation tools against the JAX package's, on the CPU, with
the same numpy-seeded inputs (no SLAM session).

Tolerances:
  * masked PSNR, SSIM, MS-SSIM, depth L1, frustum culling, the analytic
    room mesh, the TUM-file ATE, the 3-D and 2-D reconstruction metrics:
    exact (numpy copies; the rasterizer is a copy of the same C++ code);
  * LPIPS: 1e-5 relative (float32 convolutions in XLA and in torch sum in
    different orders);
  * the point-splat z-buffer: exact (the same float32 projection, the
    same round-half-to-even and a min over the same samples);
  * mesh_from_renders: the fused tsdf and weights within 1e-5, as tests/
    test_torch_tsdf.py holds integrate, and colors within 1e-5 on all but
    0.1% of voxels (one on a pixel border takes the neighbouring pixel's
    color when the float32 projection differs in its last bit); the
    meshes, matched by nearest vertex, within 2e-3 voxel (99% within
    1e-5: an edge point va / (va - vb) divides a 1e-5 tsdf difference by
    a small va - vb) and their colors within 1e-4.
  * the YAML reader: equal dicts to yaml.safe_load on every config.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.spatial import cKDTree

from conftest import small_cfg
from loopy_slam_torch import config as tconfig
from loopy_slam_torch.ops import raster as traster
from loopy_slam_torch.ops import tsdf as ttsdf
from loopy_slam_torch.tools import cull_mesh as tcull
from loopy_slam_torch.tools import eval_ate as tate
from loopy_slam_torch.tools import eval_images as timages
from loopy_slam_torch.tools import eval_recon as trecon
from loopy_slam_torch.tools import get_mesh_tsdf_fusion as tfusion
from loopy_slam_torch.utils import datasets as tdatasets
from loopy_slam_torch.utils import io as tio
from loopy_slam_torch.utils import lpips as tlpips
from loopy_slam_torch.utils import metrics as tmetrics
from loopy_slam_torch.utils import visualizer as tvis
from loopy_slam_tpu.native.build import raster_mesh_depth as j_raster
from loopy_slam_tpu.ops import raster as jraster
from loopy_slam_tpu.ops import tsdf as jtsdf
from loopy_slam_tpu.tools import cull_mesh as jcull
from loopy_slam_tpu.tools import eval_ate as jate
from loopy_slam_tpu.tools import eval_images as jimages
from loopy_slam_tpu.tools import eval_recon as jrecon
from loopy_slam_tpu.tools import get_mesh_tsdf_fusion as jfusion
from loopy_slam_tpu.utils import datasets as jdatasets
from loopy_slam_tpu.utils import io as jio
from loopy_slam_tpu.utils import metrics as jmetrics
from torch_cpu import read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LPIPS_NPZ = os.path.join(ROOT, "pretrained", "lpips_alex_randfeat.npz")
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))


def _images(seed, H=64, W=96):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    img = np.clip(ref + rng.normal(0, 0.1, ref.shape), 0, 1).astype(
        np.float32)
    d_ref = rng.uniform(0.5, 3, (H, W)).astype(np.float32)
    d_ref[rng.uniform(size=(H, W)) < 0.1] = 0
    depth = (d_ref + rng.normal(0, 0.02, d_ref.shape)).astype(np.float32)
    return img, ref, depth, d_ref


def _room():
    cfg = small_cfg()
    return cfg, jdatasets.Synthetic(cfg), tdatasets.Synthetic(cfg)


@pytest.fixture(scope="module")
def room_mesh():
    cfg, jds, _ = _room()
    return cfg, jds, jds.gt_mesh(divisions=24)


# ---------------------------------------------------------------------------
# image metrics and LPIPS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 96), (20, 30)])
def test_image_metrics_equal_jax(shape):
    """masked PSNR, SSIM, MS-SSIM (the small shape takes the renormalized
    scale weights) and depth L1: exact copies."""
    img, ref, depth, d_ref = _images(0, *shape)
    mask = d_ref > 0
    assert tmetrics.masked_psnr(img, ref, mask) == jmetrics.masked_psnr(
        img, ref, mask)
    assert tmetrics.ssim(img, ref) == jmetrics.ssim(img, ref)
    assert tmetrics.ms_ssim(img, ref) == jmetrics.ms_ssim(img, ref)
    assert tmetrics.depth_l1(depth, d_ref) == jmetrics.depth_l1(depth, d_ref)
    assert tmetrics.depth_l1(depth, d_ref, mask) == jmetrics.depth_l1(
        depth, d_ref, mask)


@pytest.mark.parametrize("seed", [1, 2])
def test_lpips_matches_jax(seed):
    img, ref, _, _ = _images(seed)
    got = tmetrics.lpips(img, ref, LPIPS_NPZ, device="cpu")
    want = jmetrics.lpips(img, ref, LPIPS_NPZ)
    assert got > 0
    assert got == pytest.approx(want, rel=1e-5)


def test_lpips_weights_resolve_from_the_repo_and_none_without(monkeypatch,
                                                              tmp_path):
    img, ref, _, _ = _images(3)
    monkeypatch.chdir(tmp_path)  # the shipped path is repo-relative
    rel = "pretrained/lpips_alex_randfeat.npz"
    assert tmetrics.lpips(img, ref, rel, device="cpu") == pytest.approx(
        jmetrics.lpips(img, ref, LPIPS_NPZ), rel=1e-5)
    assert tmetrics.lpips(img, ref, None, device="cpu") is None
    bad = tmp_path / "bad.npz"
    np.savez(bad, shift=np.zeros(3))
    with pytest.raises(ValueError, match="missing"):
        tlpips.load_lpips(str(bad), device="cpu")


def test_evaluate_renders_matches_jax():
    pairs = [_images(s) for s in (4, 5)]
    pairs = [(img, ref, d, dr) for img, ref, d, dr in pairs]
    got = timages.evaluate_renders(pairs, LPIPS_NPZ, device="cpu")
    want = jimages.evaluate_renders(pairs, LPIPS_NPZ)
    assert set(got) == set(want)
    for k in ("psnr", "ms_ssim", "depth_l1", "n_frames"):
        assert got[k] == want[k], k
    assert got["lpips"] == pytest.approx(want["lpips"], rel=1e-5)


# ---------------------------------------------------------------------------
# meshes: io, the analytic room, rasterization, culling, metrics
# ---------------------------------------------------------------------------

def test_gt_mesh_equals_jax():
    cfg, jds, tds = _room()
    for div in (60, 24):
        jv, jf = jds.gt_mesh(divisions=div)
        tv, tf = tds.gt_mesh(divisions=div)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)


@pytest.mark.parametrize("colored", [False, True])
def test_ply_mesh_round_trip_with_jax_reader(tmp_path, room_mesh, colored):
    _, _, (v, f) = room_mesh
    c = (np.random.default_rng(0).uniform(size=v.shape) if colored
         else None)
    path = str(tmp_path / "m.ply")
    tio.write_ply_mesh(path, v, f, c)
    for read in (tio.read_ply_mesh, jio.read_ply_mesh):
        rv, rf, rc = read(path)
        np.testing.assert_array_equal(rv, v.astype(np.float32))
        np.testing.assert_array_equal(rf, f)
        if colored:
            np.testing.assert_array_equal(
                rc, np.clip(c * 255.0, 0, 255).astype(np.uint8))
        else:
            assert rc is None


def _views(jds, idx=(0, 4, 8)):
    return [jds.poses[i] for i in idx]


def test_raster_depth_bit_equal_to_jax_native(room_mesh):
    cfg, jds, (v, f) = room_mesh
    cam = cfg["cam"]
    hit = 0
    for c2w in _views(jds):
        args = (c2w, 60, 80, cam["fx"], cam["fy"], cam["cx"], cam["cy"])
        got = traster.raster_mesh_depth(v, f, *args)
        want = j_raster(v, f, *args)
        assert want is not None  # the JAX native library built
        np.testing.assert_array_equal(got, want)
        hit += int((got > 0).sum())
    assert hit > 3 * 60 * 80 * 0.9


def test_raster_build_failure_raises(monkeypatch):
    """No silent fallback: without a compiler the rasterizer raises."""
    from loopy_slam_torch.csrc import build

    monkeypatch.setattr(build, "_host_libs", {})
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(FileNotFoundError, match="g\\+\\+"):
        traster.raster_mesh_depth(np.zeros((3, 3)), np.array([[0, 1, 2]]),
                                  np.eye(4), 2, 2, 1.0, 1.0, 0.5, 0.5)


def test_render_depth_points_equal_jax(room_mesh):
    cfg, jds, (v, f) = room_mesh
    pts, _ = jraster.sample_mesh_surface(v, f, 100000,
                                         np.random.default_rng(1))
    tpts, _ = traster.sample_mesh_surface(v, f, 100000,
                                          np.random.default_rng(1))
    np.testing.assert_array_equal(tpts, pts)
    cam = cfg["cam"]
    pts = pts.astype(np.float32)
    for c2w in _views(jds):
        c2w = np.asarray(c2w, np.float32)
        k = (60, 80, cam["fx"], cam["fy"], cam["cx"], cam["cy"])
        want = np.asarray(jraster.render_depth_points(
            jnp.asarray(pts), jnp.asarray(c2w), *k))
        got = traster.render_depth_points(torch.as_tensor(pts),
                                          torch.as_tensor(c2w), *k).numpy()
        assert (want > 0).mean() > 0.5
        np.testing.assert_array_equal(got, want)


def test_cull_mesh_equals_jax(room_mesh):
    cfg, jds, (v, f) = room_mesh
    cam = {k: cfg["cam"][k] for k in ("H", "W", "fx", "fy", "cx", "cy")}
    colors = np.random.default_rng(2).uniform(size=v.shape)
    got = tcull.cull_mesh(v, f, _views(jds), cam, colors, return_unseen=True)
    want = jcull.cull_mesh(v, f, _views(jds), cam, colors,
                           return_unseen=True)
    assert 0 < len(got[1]) < len(f) and len(got[3]) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _rec_mesh(v, f, seed=3):
    """A reconstruction: the room mesh moved and roughened a little."""
    rng = np.random.default_rng(seed)
    return v + rng.normal(0, 0.005, v.shape) + [0.01, 0.0, -0.01], f


def test_recon_metrics_equal_jax(room_mesh):
    cfg, jds, (v, f) = room_mesh
    cam = {k: cfg["cam"][k] for k in ("H", "W", "fx", "fy", "cx", "cy")}
    gv, gf, _, unseen = jcull.cull_mesh(v, f, _views(jds), cam,
                                        return_unseen=True)
    rec = _rec_mesh(gv, gf)
    got = trecon.calc_3d_metric(rec, (gv, gf), n_samples=20000,
                                rng=np.random.default_rng(5))
    want = jrecon.calc_3d_metric(rec, (gv, gf), n_samples=20000,
                                 rng=np.random.default_rng(5))
    assert got == want
    assert 0 < got["accuracy"] < 3 and got["fscore"] > 10
    # without and with the unseen-region view rejection (three views see
    # too little of the room for any virtual view to pass it: nan)
    for pc in (None, unseen):
        got = trecon.calc_2d_metric(rec, (gv, gf), n_views=5, pc_unseen=pc,
                                    rng=np.random.default_rng(6))
        want = jrecon.calc_2d_metric(rec, (gv, gf), n_views=5,
                                     pc_unseen=pc,
                                     rng=np.random.default_rng(6))
        np.testing.assert_equal(got, want)
        assert np.isfinite(got["depth l1"]) == (pc is None)


def test_mesh_from_renders_within_tsdf_tolerance():
    cfg, jds, _ = _room()
    renders, poses = [], []
    for i in (0, 3, 6):
        _, c, d, p = jds[i]
        renders.append((c, d))
        poses.append(p)
    cam = {k: cfg["cam"][k] for k in ("fx", "fy", "cx", "cy")}
    jg = jtsdf.fuse_frames(renders, poses, *cam.values(), voxel=0.05)
    tg = ttsdf.fuse_frames(renders, poses, *cam.values(), voxel=0.05,
                           device="cpu")
    for name in ("tsdf", "weight", "origin", "voxel"):
        np.testing.assert_allclose(getattr(tg, name).numpy(),
                                   np.asarray(getattr(jg, name)), atol=1e-5,
                                   err_msg=name)
    # a voxel that projects onto a pixel border takes the neighbouring
    # pixel's color when the float32 projection differs in its last bit
    dc = np.abs(tg.color.numpy() - np.asarray(jg.color))
    assert (dc > 1e-5).mean() < 1e-3
    jv, jf, jc = jfusion.mesh_from_renders(renders, poses, cam, voxel=0.05)
    tv, tf, tc = tfusion.mesh_from_renders(renders, poses, cam, voxel=0.05,
                                           device="cpu")
    assert len(jf) > 1000
    assert abs(len(tv) - len(jv)) <= 1e-3 * len(jv)
    assert abs(len(tf) - len(jf)) <= 1e-3 * len(jf)
    d, nn = cKDTree(jv).query(tv)
    assert d.max() <= 2e-3 * 0.05 and np.quantile(d, 0.99) <= 1e-5 * 0.05
    dc = np.abs(tc - jc[nn])
    assert dc.max() <= 1e-4 and np.quantile(dc, 0.99) <= 1e-5


def test_weld_of_a_grid_wider_than_the_packed_keys():
    """Grids over 209 voxels a side weld by rows: a flat wall 12 m wide at
    5 cm voxels (240 a side) comes out as one connected sheet."""
    depth = np.full((60, 80), 2.0, np.float32)
    color = np.full((60, 80, 3), 0.5, np.float32)
    grid = ttsdf.fuse_frames([(color, depth)], [np.eye(4, dtype=np.float32)],
                             10.0, 10.0, 39.5, 29.5, voxel=0.05, trunc=0.15,
                             device="cpu")
    assert max(grid.tsdf.shape) > 209
    v, f, _ = ttsdf.extract_mesh(grid)
    assert len(f) > 1000 and np.abs(v[:, 2] + 2.0).max() < 0.08
    # welded: most vertices are shared by several faces
    assert np.bincount(f.ravel()).mean() > 4


# ---------------------------------------------------------------------------
# ATE from TUM files
# ---------------------------------------------------------------------------

def test_evaluate_tum_files_equals_jax(tmp_path):
    rng = np.random.default_rng(7)
    n = 40
    t = np.cumsum(rng.normal(0, 0.05, (n, 3)), 0)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    stamps = 1000.0 + 0.033 * np.arange(n)
    gt = tmp_path / "gt.txt"
    est = tmp_path / "est.txt"
    with open(gt, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for s, a, b in zip(stamps, t, q):
            f.write(" ".join(f"{x:.6f}" for x in (s, *a, *b)) + "\n")
    with open(est, "w") as f:
        for s, a, b in zip(stamps + 0.004, t + rng.normal(0, 0.01, t.shape),
                           q):
            f.write(",".join(f"{x:.6f}" for x in (s, *a, *b)) + "\n")
    for kw in ({}, {"offset": 0.004, "max_difference": 0.01, "scale": 1.5}):
        got = tate.evaluate_tum_files(str(est), str(gt), **kw)
        want = jate.evaluate_tum_files(str(est), str(gt), **kw)
        assert got == want and got["n"] == n
    out = tate.main(["--est_traj", str(est), "--gt_traj", str(gt)])
    assert out["absolute_translational_error.rmse"] == out["rmse"] \
        == jate.evaluate_tum_files(str(est), str(gt))["rmse"]


# ---------------------------------------------------------------------------
# the YAML reader and the PNG writer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_reader_equals_safe_load(path):
    full = os.path.join(ROOT, path)
    with open(full) as f:
        want = yaml.safe_load(f)
    assert tconfig.read_yaml(full) == want


def test_yaml_reader_reads_the_subset():
    text = ('# comment\na: 1\nb: {c: [1, 2.5, 1e-3, -4], d: "x # y"}\n'
            "e:\n  f: ~\n  g: null\n  h: True\n  i: 'it''s'\n"
            "  j: [a, b,\n     c]\n  k: 1000.\nl: plain text # tail\n")
    want = {"a": 1, "b": {"c": [1, 2.5, 1e-3, -4], "d": "x # y"},
            "e": {"f": None, "g": None, "h": True, "i": "it's",
                  "j": ["a", "b", "c"], "k": 1000.0},
            "l": "plain text"}
    assert tconfig.parse_yaml(text) == want


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb:\n  - x\n", 3),        # block sequence
    ("a: &anchor 1\n", 1),           # anchor
    ("a: 0x1F\n", 1),                # hex number
    ("a:\n\tb: 1\n", 2),             # tab indentation
    ("a: [1, 2\n", 1),               # unclosed flow list
    ("a: 1\n  b: 2\n", 2),           # bad indentation
    ("a: |\n  text\n", 1),           # block scalar
])
def test_yaml_reader_refuses_naming_file_and_line(text, line):
    with pytest.raises(tconfig.YAMLError, match=f"cfg.yaml:{line}:"):
        tconfig.parse_yaml(text, "cfg.yaml")


def test_load_config_needs_no_pyyaml(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml fails
    from loopy_slam_tpu.config import load_config as jload

    got = tconfig.load_config(os.path.join(ROOT, "configs", "Synthetic",
                                           "room.yaml"))
    monkeypatch.delitem(sys.modules, "yaml")
    assert got == jload(os.path.join(ROOT, "configs", "Synthetic",
                                     "room.yaml"))


def test_png_round_trip_and_six_panels(tmp_path):
    img, ref, depth, d_ref = _images(8, 30, 40)
    panels = tvis.six_panels(d_ref, depth, ref, img)
    assert panels.shape == (60, 120, 3) and panels.dtype == np.uint8
    path = str(tmp_path / "p.png")
    tvis.write_png(path, panels)
    np.testing.assert_array_equal(read_png(path), panels)
    # the input-rgb panel is the clipped input
    np.testing.assert_array_equal(
        panels[30:, :40], np.rint(np.clip(ref, 0, 1) * 255).astype(np.uint8))
    lut = tvis.colormap(np.array([[0.0, 1.0]]), 0, 1)
    assert lut[0, 0, 2] > lut[0, 0, 0] and lut[0, 1, 1] > 0.9  # plasma ends


class _FakeSession:
    """Stands in for LoopySLAM: render_img returns fixed arrays."""

    def __init__(self, depth, color):
        self.out, self.calls = (depth, color), 0

    def render_img(self, c2w, gt_depth, r_query_map=None):
        self.calls += 1
        return self.out


def test_visualizer_gate_and_rendered_image_dumps(tmp_path):
    img, ref, depth, d_ref = _images(9, 30, 40)
    fake = _FakeSession(depth, img)
    vis = tvis.Visualizer(5, str(tmp_path / "vis"), fake, verbose=False)
    for idx in (0, 3, 7):  # idx 0 and idx % 5 != 0 do not fire
        assert vis.vis(idx, 9, d_ref, ref, np.eye(4)) is None
    assert fake.calls == 0
    out = vis.vis(10, 9, d_ref, ref, np.eye(4), save_rendered_image=True)
    assert out is not None and fake.calls == 1
    assert vis.vis(3, 9, d_ref, ref, np.eye(4), freq_override=True)
    assert sorted(os.listdir(tmp_path / "vis")) == [
        "00003_0009.png", "00010_0009.png", "color_00010.npy",
        "depth_00010.npy"]
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "vis" / "00010_0009.png")),
        tvis.six_panels(d_ref, depth, ref, img))
    np.testing.assert_array_equal(np.load(tmp_path / "vis" / "color_00010.npy"),
                                  np.clip(img, 0, 1))
