"""The port's JPEG codec and resize against OpenCV (which the JAX package
reads its JPEG datasets with), on the CPU.

Tolerances:
  * `read_jpeg`: bit-equal to cv2.imread (channels reversed: cv2 returns
    BGR) on files cv2 writes: qualities 90, 92 and 98; 4:2:0, 4:2:2 and
    4:4:4 sampling; gray; sizes that are not multiples of 16; a restart
    interval. Progressive, truncated, corrupt, CMYK, 12-bit, rotated and
    non-JPEG files raise, naming the file.
  * `write_jpeg`: the bytes of cv2.imwrite at the same quality (this
    environment's OpenCV 5 bundles libjpeg-turbo 3.1, whose compressor the
    writer follows), and so the same decoded pixels.
  * `resize_linear`: bit-equal to OpenCV's own INTER_LINEAR code on
    float32 (cv2.resize with IPP switched off) at 968x1296 -> 480x640,
    a shrink of another ratio and an enlargement, with 3 channels and 1,
    and an exact 2x shrink of a 3-channel image (OpenCV's scalar 2x2
    average; its one- and four-channel SIMD sums group the four terms
    another way, by the host's vector width, and the port resizes only
    3-channel color).
    With IPP on (this environment's default, which the JAX loader runs
    with here) cv2.resize takes Intel's routine, which rounds
    differently: the test states how many values differ and bounds them
    at 1e-4 (0.026 of an 8-bit color step).
"""

import os

import cv2
import numpy as np
import pytest

from loopy_slam_torch.utils import imageio

SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
SIZES = [(61, 83), (242, 324), (17, 9), (1, 1)]


def _image(H, W, seed=0):
    """Smooth color with noise: every quantized coefficient band in use."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    img = np.stack([127 + 100 * np.sin(x / 7.0 + y / 11.0),
                    127 + 100 * np.cos(x / 5.0 - y / 13.0),
                    127 + 120 * np.sin((x + y) / 9.0)], -1)
    img = img + rng.normal(0, 20, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_rgb(path):
    return cv2.imread(path)[..., ::-1]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("quality", [90, 92, 98])
@pytest.mark.parametrize("sampling", ["default", "420", "422", "444"])
def test_read_jpeg_equals_imread(tmp_path, size, quality, sampling):
    img = _image(*size)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling != "default":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    path = str(tmp_path / "a.jpg")
    assert cv2.imwrite(path, img[..., ::-1], params)
    np.testing.assert_array_equal(imageio.read_jpeg(path), _cv2_rgb(path))


@pytest.mark.parametrize("size", SIZES + [(968 // 4, 1296 // 4)])
def test_read_gray_and_restart_interval(tmp_path, size):
    img = _image(*size, seed=1)
    gray = str(tmp_path / "g.jpg")
    cv2.imwrite(gray, img[..., 0], [cv2.IMWRITE_JPEG_QUALITY, 92])
    got = imageio.read_jpeg(gray)
    assert got.shape == size + (3,)
    np.testing.assert_array_equal(got, _cv2_rgb(gray))
    rst = str(tmp_path / "r.jpg")
    cv2.imwrite(rst, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 92,
                                      cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    assert b"\xff\xdd" in open(rst, "rb").read()  # a DRI segment
    np.testing.assert_array_equal(imageio.read_jpeg(rst), _cv2_rgb(rst))


def test_read_full_size_frames(tmp_path):
    """ScanNet's 968x1296 (q90) and Replica's 680x1200 (q92)."""
    for (H, W), q in (((968, 1296), 90), ((680, 1200), 92)):
        path = str(tmp_path / f"{H}.jpg")
        cv2.imwrite(path, _image(H, W, seed=2)[..., ::-1],
                    [cv2.IMWRITE_JPEG_QUALITY, q])
        np.testing.assert_array_equal(imageio.read_jpeg(path),
                                      _cv2_rgb(path))


def _rewrite(data: bytes, marker: int, fn) -> bytes:
    """data with the body of its first `marker` segment passed through
    fn."""
    pos = 2
    while True:
        m, n = data[pos + 1], int.from_bytes(data[pos + 2:pos + 4], "big")
        if m == marker:
            body = fn(data[pos + 4:pos + 2 + n])
            return (data[:pos + 2] + (len(body) + 2).to_bytes(2, "big")
                    + body + data[pos + 2 + n:])
        pos += 2 + n


@pytest.mark.parametrize("case", [
    "progressive", "truncated", "corrupt", "not_jpeg", "12bit", "cmyk",
    "orientation", "no_eoi"])
def test_unsupported_files_raise_with_their_name(tmp_path, case):
    img = _image(40, 56, seed=3)
    path = str(tmp_path / f"{case}.jpg")
    cv2.imwrite(path, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90]
                + ([cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
                   if case == "progressive" else []))
    data = open(path, "rb").read()
    sos = data.index(b"\xff\xda")
    if case == "truncated":
        data = data[:sos + (len(data) - sos) // 2]
    elif case == "corrupt":  # an invalid code run through the scan
        data = data[:sos + 40] + b"\xff\x00" * 40 + data[sos + 120:]
    elif case == "not_jpeg":
        data = b"\x89PNG" + data[4:]
    elif case == "12bit":
        data = _rewrite(data, 0xC0, lambda b: bytes([12]) + b[1:])
    elif case == "cmyk":
        data = _rewrite(data, 0xC0, lambda b: b[:5] + bytes([4]) + b[6:]
                        + bytes([4, 0x11, 1]))
    elif case == "orientation":  # an Exif APP1 with orientation 6
        tiff = (b"MM\x00\x2a\x00\x00\x00\x08\x00\x01"
                b"\x01\x12\x00\x03\x00\x00\x00\x01\x00\x06\x00\x00"
                b"\x00\x00\x00\x00")
        app1 = b"Exif\x00\x00" + tiff
        data = (data[:2] + b"\xff\xe1" + (len(app1) + 2).to_bytes(2, "big")
                + app1 + data[2:])
    elif case == "no_eoi":
        data = data[:-2]
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=os.path.basename(path)):
        imageio.read_jpeg(path)


@pytest.mark.parametrize("size", SIZES + [(480, 640), (3, 5)])
@pytest.mark.parametrize("quality", [90, 92, 98])
def test_write_jpeg_writes_imwrites_bytes(tmp_path, size, quality):
    img = _image(*size, seed=4)
    ours, theirs = str(tmp_path / "w.jpg"), str(tmp_path / "c.jpg")
    imageio.write_jpeg(ours, img, quality)
    cv2.imwrite(theirs, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    np.testing.assert_array_equal(imageio.read_jpeg(ours), _cv2_rgb(ours))


def test_write_jpeg_rejects_other_arrays(tmp_path):
    with pytest.raises(ValueError, match="uint8 RGB"):
        imageio.write_jpeg(str(tmp_path / "x.jpg"),
                           np.zeros((4, 4), np.uint8))


RESIZES = [((968, 1296), (480, 640), 3), ((100, 130), (37, 53), 3),
           ((61, 83), (121, 160), 3), ((64, 80), (32, 40), 3),
           ((968, 1296), (480, 640), 1), ((100, 130), (37, 53), 1),
           ((61, 83), (121, 160), 1)]


@pytest.fixture
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


@pytest.mark.parametrize("src,dst,channels", RESIZES)
def test_resize_linear_equals_opencv(no_ipp, src, dst, channels):
    rng = np.random.default_rng(5)
    img = rng.random(src + ((channels,) if channels > 1 else ())
                     ).astype(np.float32)
    want = cv2.resize(img, dst[::-1])
    got = imageio.resize_linear(img, dst[::-1])
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resize_linear_against_ipp():
    """cv2.resize's default route here (IPP): the count of values that
    differ, and their bound."""
    if not cv2.ipp.useIPP():
        pytest.skip("this OpenCV runs without IPP")
    rng = np.random.default_rng(6)
    img = (np.round(rng.random((968, 1296, 3)) * 255) / 255).astype(
        np.float32)  # decoded 8-bit color, as the loader resizes it
    want = cv2.resize(img, (640, 480))
    got = imageio.resize_linear(img, (640, 480))
    diff = np.abs(got - want)
    print(f"IPP: {int((diff > 0).sum())} of {diff.size} values differ, "
          f"max {diff.max():.3g}")
    assert diff.max() <= 1e-4


def test_resize_linear_same_size_is_a_copy():
    img = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    out = imageio.resize_linear(img, (4, 2))
    np.testing.assert_array_equal(out, img)
    assert out is not img
    with pytest.raises(TypeError):
        imageio.resize_linear(img.astype(np.float64), (2, 1))


def test_port_sources_import_no_jax_cv2_or_pil():
    """No module of the port and not chip_smoke.py imports jax, the JAX
    package, cv2 or PIL (the card's machine has none of them)."""
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|loopy_slam_tpu|cv2|"
                     r"PIL)\b", re.M)
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root, "loopy_slam_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    found = {}
    for path in files:
        with open(path) as f:
            hits = pat.findall(f.read())
        if hits:
            found[os.path.relpath(path, root)] = hits
    assert not found, found
