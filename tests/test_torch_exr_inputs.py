"""The port's last inputs against the JAX package's, on the CPU: the EXR
codec, the Azure and CoFusion loaders, cam.crop_size and the nearest
resize behind it, and the fixture writer's two new formats.

Tolerances:
  * EXR: the port's `write_exr` writes the JAX copy's bytes, and each
    package reads the other's files to the same arrays (the cases of
    tests/test_exr.py: every compression by dtype, several channels, no
    'Y' channel, a file that is not an EXR).
  * `resize_nearest`: bit-equal to cv2.resize(INTER_NEAREST) at integer
    and non-integer ratios, up and down, for float32, uint16 and RGB.
  * the loaders: frame by frame, color, depth and poses bit-equal to the
    JAX loaders' on the port writer's sequences (JAX reads with cv2; the
    port's JPEG, PNG and EXR readers are bit-equal to it).
  * crop_size on Replica-, Azure- and CoFusion-layout sequences: depth
    bit-equal (INTER_NEAREST); color bit-equal with OpenCV's own resize
    code (IPP off), and within 1e-4 on [0, 1] of the IPP route cv2 takes
    here by default (tests/test_torch_jpeg.py's bound). The TUM
    layout's case is in tests/test_torch_tum.py.
"""

import copy
import os

import cv2
import numpy as np
import pytest

from conftest import small_cfg
from loopy_slam_torch.tools import make_sensor_fixtures as tfix
from loopy_slam_torch.utils import datasets as tds
from loopy_slam_torch.utils import exr as texr
from loopy_slam_torch.utils.imageio import resize_nearest
from loopy_slam_tpu.utils import datasets as jds
from loopy_slam_tpu.utils import exr as jexr

FRAMES, SPEED = 3, 1.0 / 60


# ------------------------------------------------------------------ EXR

def _exr_channels(case):
    rng = np.random.default_rng(0)
    if case.startswith("depth"):
        _, compression, dtype = case.split("-")
        # an odd height: a partial last block (16 lines under ZIP)
        if dtype == "uint32":
            y = rng.integers(0, 2 ** 31, (37, 53)).astype(np.uint32)
        else:
            y = rng.uniform(0.2, 5.0, (37, 53)).astype(dtype)
        return {"Y": y}, compression
    if case == "multichannel":
        return {"R": rng.uniform(0, 1, (20, 31)).astype(np.float32),
                "G": rng.uniform(0, 1, (20, 31)).astype(np.float16),
                "Y": rng.uniform(0, 9, (20, 31)).astype(np.float32)}, "ZIP"
    if case == "missing_y":
        return {"R": rng.uniform(0, 1, (20, 31)).astype(np.float32),
                "G": rng.uniform(0, 1, (20, 31)).astype(np.float16)}, "ZIPS"
    raise ValueError(case)


EXR_CASES = ([f"depth-{c}-{d}" for c in ("NONE", "ZIPS", "ZIP")
              for d in ("float32", "float16", "uint32")]
             + ["multichannel", "missing_y", "not_exr"])


@pytest.mark.parametrize("case", EXR_CASES)
def test_exr_matches_jax(tmp_path, case):
    if case == "not_exr":
        path = str(tmp_path / "bogus.exr")
        with open(path, "wb") as f:
            f.write(b"not an exr at all")
        for mod in (texr, jexr):
            with pytest.raises(ValueError, match="not an EXR"):
                mod.read_exr(path)
        return
    chans, compression = _exr_channels(case)
    tp, jp = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
    texr.write_exr(tp, chans, compression=compression)
    jexr.write_exr(jp, chans, compression=compression)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    for reader in (texr, jexr):
        for path in (tp, jp):
            got = reader.read_exr(path)
            assert sorted(got) == sorted(chans)
            for name, want in chans.items():
                assert got[name].dtype == want.dtype
                np.testing.assert_array_equal(got[name], want)
    td, jd = texr.read_exr_depth(jp), jexr.read_exr_depth(tp)
    if "Y" not in chans:
        assert td is None and jd is None
        return
    assert td.dtype == np.float32
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(td, chans["Y"].astype(np.float32))


def test_exr_rejects_what_it_does_not_read(tmp_path):
    """A compression outside NONE/ZIPS/ZIP raises with its name."""
    path = str(tmp_path / "piz.exr")
    texr.write_exr(path, {"Y": np.ones((4, 5), np.float32)}, "NONE")
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    at = buf.index(b"compression\x00compression\x00") + 28
    buf[at] = 4  # PIZ
    with open(path, "wb") as f:
        f.write(bytes(buf))
    with pytest.raises(ValueError, match="PIZ not supported"):
        texr.read_exr(path)


# ------------------------------------------------------- resize_nearest

SIZE_PAIRS = [((480, 640), (384, 512)), ((720, 1280), (384, 512)),
              ((968, 1296), (360, 640)), ((680, 1200), (240, 320)),
              ((680, 1200), (500, 700)), ((120, 160), (240, 320)),
              ((37, 53), (961, 1283)), ((480, 640), (161, 215))]


@pytest.mark.parametrize("src,dst", SIZE_PAIRS)
def test_resize_nearest_bit_equal_to_cv2(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    imgs = [rng.random(src).astype(np.float32),
            rng.integers(0, 65535, src).astype(np.uint16),
            rng.integers(0, 255, src + (3,)).astype(np.uint8)]
    for img in imgs:
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST)
        got = resize_nearest(img, dst[::-1])
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- loaders

def _cfg(dataset, root, cam, **over):
    cfg = small_cfg()
    cfg["dataset"] = dataset
    cfg["data"] = {**cfg["data"], "input_folder": root}
    cfg["cam"] = {**cfg["cam"], **cam, **over}
    return cfg


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """The port writer's Azure, CoFusion and Replica sequences."""
    base = tmp_path_factory.mktemp("inputs")
    out = {}
    for name, write, cam in (
            ("azure", tfix.write_azure, tfix.AZURE_CAM),
            ("cofusion", tfix.write_cofusion, tfix.COFUSION_CAM),
            ("replica", tfix.write_replica, tfix.REPLICA_CAM)):
        root = str(base / name)
        write(root, FRAMES, SPEED)
        out[name] = (root, cam)
    return out


def _same_frames(cfg, color_atol=0.0):
    tds_, jds_ = tds.get_dataset(cfg), jds.get_dataset(copy.deepcopy(cfg))
    assert len(tds_) == len(jds_) == FRAMES
    assert tds_.color_paths == jds_.color_paths
    assert tds_.depth_paths == jds_.depth_paths
    for i in range(FRAMES):
        ti, tc, td, tp = tds_[i]
        ji, jc, jd, jp = jds_[i]
        assert ti == ji
        assert tc.dtype == jc.dtype == np.float32
        assert tc.shape == jc.shape and td.shape == jd.shape
        if color_atol:
            np.testing.assert_allclose(tc, jc, rtol=0, atol=color_atol)
        else:
            np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tp, jp)
    return tds_


@pytest.mark.parametrize("name", ["azure", "cofusion"])
def test_loader_matches_jax(sequences, name):
    root, cam = sequences[name]
    ds = _same_frames(_cfg(name, root, cam))
    _, color, depth, c2w = ds[1]
    assert color.shape == (cam["H"], cam["W"], 3)
    if name == "cofusion":  # identity poses; depth is Y / png_depth_scale
        np.testing.assert_array_equal(c2w, np.eye(4, dtype=np.float32))
        y = texr.read_exr_depth(ds.depth_paths[1])
        np.testing.assert_array_equal(
            depth, y / np.float32(cam["png_depth_scale"]))
    else:  # the log's poses, Y and Z flipped back to the render's
        want = tfix.make_dataset(cam, FRAMES, SPEED).poses[1]
        np.testing.assert_allclose(c2w, want, atol=1e-6)


def test_azure_without_a_trajectory_log(sequences, tmp_path):
    root, cam = sequences["azure"]
    bare = tmp_path / "bare"
    os.makedirs(bare)
    for sub in ("color", "depth"):
        os.symlink(os.path.join(root, sub), bare / sub)
    ds = _same_frames(_cfg("azure", str(bare), cam))
    assert all(np.array_equal(p, np.eye(4)) for p in ds.poses)


CROPS = {"azure": [384, 512], "cofusion": [300, 400], "replica": [340, 600]}


@pytest.mark.parametrize("ipp", [False, True])
@pytest.mark.parametrize("name", sorted(CROPS))
def test_crop_size_matches_jax(sequences, name, ipp):
    """Both images go to crop_size after color reaches depth's size; the
    intrinsics follow in update_cam (separate x and y scales for Azure's
    384x512 of 720x1280)."""
    from loopy_slam_torch.slam import update_cam
    from loopy_slam_tpu.slam import update_cam as jupdate_cam

    root, cam = sequences[name]
    cfg = _cfg(name, root, cam, crop_size=CROPS[name], crop_edge=2)
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(ipp)
    try:
        ds = _same_frames(cfg, color_atol=1e-4 if ipp else 0.0)
    finally:
        cv2.ipp.setUseIPP(was)
    _, color, depth, _ = ds[0]
    ch, cw = CROPS[name]
    assert depth.shape == (ch - 4, cw - 4) and color.shape == (ch - 4,
                                                                cw - 4, 3)
    tc, jc = update_cam(cfg), jupdate_cam(copy.deepcopy(cfg))
    for k in ("H", "W", "fx", "fy", "cx", "cy"):
        assert tc[k] == jc[k]
    assert (tc["H"], tc["W"]) == depth.shape


def test_cofusion_fixture_round_trip(sequences):
    """The writer's EXR depth is the render's depth times
    png_depth_scale, ZIP-compressed; the loader gives the render back."""
    root, cam = sequences["cofusion"]
    ds = tds.get_dataset(_cfg("cofusion", root, cam))
    render = tfix.make_dataset(cam, FRAMES, SPEED)
    for i in range(FRAMES):
        _, want = render.render_frame(render.poses[i])
        with open(ds.depth_paths[i], "rb") as f:
            buf = f.read()
        assert buf[buf.index(b"compression\x00compression\x00") + 28] == 3
        got = ds[i][2]
        np.testing.assert_array_equal(
            got, (want.astype(np.float32)
                  * np.float32(cam["png_depth_scale"]))
            / np.float32(cam["png_depth_scale"]))
