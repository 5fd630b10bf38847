"""The port's Replica and ScanNet loaders and fixture writer against the
JAX package's, on the CPU, on the same files.

Tolerances:
  * the loaders: frame by frame, color, depth and poses bit-equal to the
    JAX loaders' (a Replica scene written by tests/test_dataset_formats.py
    and the ScanNet sequence of scripts/make_sensor_fixtures.py, 1296x968
    color over 640x480 depth at scale 4), inf poses kept as inf. ScanNet
    color is resized to depth's size: bit-equal with OpenCV's own resize
    code (IPP switched off); with IPP, this environment's default, the
    JAX loader's colors differ by at most 1e-4 (tests/test_torch_jpeg.py).
  * the fixture writer: its JPEGs are the JAX scripts' bytes (the writer
    writes what libjpeg-turbo writes), the pose and trajectory text files
    equal, depth equal wherever both have depth; the holes are numpy
    ellipses where cv2.ellipse draws a polygon, so a hole's edge may
    differ: mismatched pixels at most 30% of the script's hole pixels
    (measured 10-20%: at scale 4 a ScanNet hole is ~30 pixels, so its edge
    is a larger share of it than the TUM writer's 20% bound assumes).
  * tests/test_dataset_formats.py's Replica and ScanNet cases, run on the
    port's loaders with that test's own bounds.
The session on the ScanNet sequence is tests/test_torch_scannet_session.py.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from conftest import small_cfg
from loopy_slam_torch.tools import make_sensor_fixtures as tfix
from loopy_slam_torch.utils import datasets as tds
from loopy_slam_tpu.utils import datasets as jds
from test_dataset_formats import _write_png_depth, make_replica_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, SCALE, SPEED = 16, 4, 1.0 / 60


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


def _cfg(dataset, root, cam=None):
    cfg = small_cfg()
    cfg["dataset"] = dataset
    cfg["data"] = {**cfg["data"], "input_folder": root}
    if cam is not None:
        cfg["cam"] = {**cfg["cam"], **cam}
    return cfg


def _assert_same_frames(tds_, jds_):
    assert len(tds_) == len(jds_) > 0
    assert tds_.color_paths == jds_.color_paths
    assert tds_.depth_paths == jds_.depth_paths
    for i in range(len(jds_)):
        ti, tc, td, tp = tds_[i]
        ji, jc, jd, jp = jds_[i]
        assert ti == ji
        assert tc.dtype == jc.dtype == np.float32
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tp, jp)  # inf stays inf


def test_replica_loader_equals_jax(tmp_path):
    root = str(tmp_path / "replica")
    make_replica_fixture(root, small_cfg(), n=3)
    _assert_same_frames(tds.get_dataset(_cfg("replica", root)),
                        jds.get_dataset(_cfg("replica", root)))


@pytest.fixture(scope="module")
def scannet_jax_fixture(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("scannet") / "jax")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "make_sensor_fixtures.py"),
         "--format", "scannet", "--out", out, "--frames", str(FRAMES),
         "--scale", str(SCALE), "--motion-speed", str(SPEED)],
        check=True, capture_output=True, text=True)
    return out


def _scannet_cam():
    cam = tfix.scale_cam(tfix.SCANNET_DEPTH_CAM, SCALE)
    return {k: cam[k] for k in ("H", "W", "fx", "fy", "cx", "cy",
                                "png_depth_scale")} | {"crop_edge": 2}


def test_scannet_loader_equals_jax(scannet_jax_fixture, no_ipp):
    cfg = _cfg("scannet", scannet_jax_fixture, _scannet_cam())
    t, j = tds.get_dataset(cfg), jds.get_dataset(cfg)
    _assert_same_frames(t, j)
    _, color, depth, pose = t[2]
    assert color.shape[:2] == depth.shape == (120 - 4, 160 - 4)
    assert not np.isfinite(pose).all()  # the script's inf pose (seed 11)


def test_scannet_color_resize_against_ipp(scannet_jax_fixture):
    if not cv2.ipp.useIPP():
        pytest.skip("this OpenCV runs without IPP")
    cfg = _cfg("scannet", scannet_jax_fixture, _scannet_cam())
    t, j = tds.get_dataset(cfg), jds.get_dataset(cfg)
    for i in range(len(j)):
        assert np.abs(t[i][1] - j[i][1]).max() <= 1e-4
        np.testing.assert_array_equal(t[i][2], j[i][2])


def test_scannet_writer_against_the_script(scannet_jax_fixture, tmp_path):
    ours = str(tmp_path / "port")
    info = tfix.write_scannet(ours, FRAMES, SPEED, scale=SCALE)
    assert info["bad_poses"] == [2]
    for sub in ("color", "depth", "pose"):
        assert sorted(os.listdir(os.path.join(ours, "frames", sub))) == \
            sorted(os.listdir(os.path.join(scannet_jax_fixture, "frames",
                                           sub)))
    for i in range(FRAMES):
        def path(root, sub, ext):
            return os.path.join(root, "frames", sub, f"{i}.{ext}")

        with open(path(ours, "color", "jpg"), "rb") as a, \
                open(path(scannet_jax_fixture, "color", "jpg"), "rb") as b:
            assert a.read() == b.read()
        with open(path(ours, "pose", "txt")) as a, \
                open(path(scannet_jax_fixture, "pose", "txt")) as b:
            assert a.read() == b.read()
        got = cv2.imread(path(ours, "depth", "png"), cv2.IMREAD_UNCHANGED)
        want = cv2.imread(path(scannet_jax_fixture, "depth", "png"),
                          cv2.IMREAD_UNCHANGED)
        both = (got > 0) & (want > 0)
        np.testing.assert_array_equal(got[both], want[both])
        holes = int((want == 0).sum())
        assert holes > 0.001 * want.size
        assert int(((got == 0) != (want == 0)).sum()) <= 0.3 * holes


def test_replica_writer_against_the_script(tmp_path):
    frames, speed = 2, 0.004
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    tfix.write_replica(ours, frames, speed)
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "make_replica_fixture.py"),
         "--out", theirs, "--frames", str(frames), "--motion-speed",
         str(speed)], check=True, capture_output=True, text=True)
    for name in ["traj.txt"] + [f"results/{k}{i:06d}.{e}"
                                for i in range(frames)
                                for k, e in (("frame", "jpg"),
                                             ("depth", "png"))]:
        a, b = os.path.join(ours, name), os.path.join(theirs, name)
        if name.endswith(".png"):  # the same pixels (PNG bytes may differ)
            np.testing.assert_array_equal(
                cv2.imread(a, cv2.IMREAD_UNCHANGED),
                cv2.imread(b, cv2.IMREAD_UNCHANGED))
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
    ds = tds.get_dataset(_cfg("replica", ours, tfix.REPLICA_CAM))
    _, color, depth, _ = ds[1]
    assert color.shape == (680, 1200, 3) and depth.shape == (680, 1200)


# tests/test_dataset_formats.py's Replica and ScanNet cases on the port


def test_replica_loader_round_trip(tmp_path):
    cfg = small_cfg()
    root = str(tmp_path / "replica_scene")
    ds_src = make_replica_fixture(root, cfg)
    ds = tds.Replica(_cfg("replica", root))
    assert len(ds) == 3
    idx, color, depth, c2w = ds[1]
    _, c0, d0, p0 = ds_src[1]
    np.testing.assert_allclose(c2w, p0, atol=1e-5)
    assert np.abs(depth - d0).mean() < 2e-4   # uint16 quantization
    assert np.abs(color - c0).mean() < 0.03   # jpeg
    assert color.shape == (cfg["cam"]["H"], cfg["cam"]["W"], 3)


def test_scannet_loader_layout(tmp_path):
    cfg = small_cfg()
    root = str(tmp_path / "scan")
    base = os.path.join(root, "frames")
    for sub in ["color", "depth", "pose"]:
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    ds_src = jds.Synthetic(cfg)
    for i in range(2):
        _, color, depth, c2w = ds_src[i]
        bgr = cv2.cvtColor((color * 255).astype(np.uint8), cv2.COLOR_RGB2BGR)
        cv2.imwrite(os.path.join(base, "color", f"{i}.jpg"), bgr)
        _write_png_depth(os.path.join(base, "depth", f"{i}.png"), depth,
                         cfg["cam"]["png_depth_scale"])
        raw = c2w.copy()
        raw[:3, 1] *= -1
        raw[:3, 2] *= -1
        np.savetxt(os.path.join(base, "pose", f"{i}.txt"), raw)
    ds = tds.ScanNet(_cfg("scannet", root))
    assert len(ds) == 2
    idx, color, depth, c2w = ds[1]
    _, _, _, p1 = ds_src[1]
    np.testing.assert_allclose(c2w, p1, atol=1e-5)


def test_get_dataset_names_the_ported_loaders():
    """Every loader of the JAX package is in; an empty folder and an
    unknown name raise, naming the dataset."""
    assert set(tds.dataset_dict) == {"replica", "scannet", "tumrgbd",
                                     "synthetic", "azure", "cofusion"}
    for name in ("azure", "cofusion"):
        with pytest.raises(FileNotFoundError, match=name):
            tds.get_dataset(_cfg(name, "/nonexistent"))
    with pytest.raises(ValueError, match="kinect"):
        tds.get_dataset(_cfg("kinect", "/nonexistent"))
