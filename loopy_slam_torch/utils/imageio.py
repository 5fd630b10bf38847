"""The port's image files and undistortion, without cv2 or PIL (the card's
machine has neither).

  * `read_png`: 8-bit gray, RGB and RGBA and 16-bit gray PNGs,
    non-interlaced, every row filter. The stream is inflated with zlib and
    unfiltered by `csrc/png_unfilter.cpp` (g++, built at first use; a
    failed build raises). Anything else (palettes, interlacing, other bit
    depths, a bad CRC, a truncated stream) raises with the file's name and
    the reason. Channels come in the file's order (RGB, RGBA), where
    cv2.imread returns BGR.
  * `write_png`: 8-bit RGB or 16-bit gray, unfiltered rows.
  * `undistort`: `cv2.undistort(img, K, dist)` for uint8 images with
    newCameraMatrix = K, following OpenCV's own arithmetic: the map of
    `initUndistortRectifyMap` (the 5-term radial/tangential model in
    double, computed in OpenCV's stripes of rows) rounded to 1/32 px, then
    `remap` INTER_LINEAR with its 15-bit fixed-point weights, rounded half
    up, under BORDER_CONSTANT 0. `undistort_map` and `remap_linear` split
    it so a loader computes the map once per camera.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, color type) -> (channels, bytes per sample)
_FORMATS = {(8, 0): (1, 1), (16, 0): (1, 2), (8, 2): (3, 1), (8, 6): (4, 1)}
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha",
                6: "RGBA"}


def read_png(path: str) -> np.ndarray:
    """(H, W) uint8/uint16 gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8."""
    import ctypes

    from ..csrc.build import load_png_library

    with open(path, "rb") as f:
        data = f.read()

    def fail(why: str):
        raise ValueError(f"{path}: {why}")

    if data[:8] != _SIGNATURE:
        fail("not a PNG file (bad signature)")
    pos, header, idat, ended = 8, None, [], False
    while pos < len(data):
        if pos + 8 > len(data):
            fail("truncated chunk header")
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            fail(f"truncated {tag!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(tag + body) & 0xFFFFFFFF:
            fail(f"bad CRC in the {tag!r} chunk")
        pos += 12 + n
        if header is None and tag != b"IHDR":
            fail("the first chunk is not IHDR")
        if tag == b"IHDR":
            if n != 13:
                fail("IHDR of a wrong length")
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            ended = True
            break
        elif tag == b"PLTE":
            if header[3] == 3:
                fail("palette images are not supported")
        elif not tag[0] & 0x20:  # an unknown critical chunk
            fail(f"unknown critical chunk {tag!r}")
    if header is None:
        fail("no IHDR chunk")
    if not ended:
        fail("no IEND chunk (truncated file)")
    W, H, depth, ctype, comp, filt, interlace = header
    if ctype == 3:
        fail("palette images are not supported")
    if (depth, ctype) not in _FORMATS:
        fail(f"{depth}-bit {_COLOR_NAMES.get(ctype, ctype)} images are not "
             "supported (8-bit gray/RGB/RGBA and 16-bit gray are)")
    if interlace:
        fail("interlaced images are not supported")
    if comp or filt:
        fail(f"unknown compression {comp} or filter method {filt}")
    if W == 0 or H == 0:
        fail("empty image")
    ch, nbytes = _FORMATS[(depth, ctype)]
    bpp = ch * nbytes
    rowbytes = W * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        fail(f"corrupt image data ({e})")
    if len(raw) != H * (rowbytes + 1):
        fail(f"image data of {len(raw)} bytes, expected "
             f"{H * (rowbytes + 1)}")
    out = np.empty(H * rowbytes, np.uint8)
    lib = load_png_library()
    rc = lib.png_unfilter(ctypes.c_char_p(raw), out.ctypes.data, H, rowbytes,
                          bpp)
    if rc != 0:
        fail(f"unknown filter type in row {-rc - 1}")
    if nbytes == 2:
        img = out.view(">u2").astype(np.uint16)
    else:
        img = out
    return img.reshape((H, W) if ch == 1 else (H, W, ch))


def write_png(path: str, img: np.ndarray) -> None:
    """An (H, W, 3) uint8 RGB or (H, W) uint16 gray PNG (rows unfiltered)."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        H, W = img.shape[:2]
        depth, ctype, rows = 8, 2, img.reshape(H, -1)
    elif img.dtype == np.uint16 and img.ndim == 2:
        H, W = img.shape
        depth, ctype = 16, 0
        rows = img.astype(">u2").view(np.uint8).reshape(H, -1)
    else:
        raise ValueError(f"write_png takes (H, W, 3) uint8 or (H, W) uint16, "
                         f"got {img.dtype} {img.shape}")
    raw = np.concatenate([np.zeros((H, 1), np.uint8),
                          np.ascontiguousarray(rows)], 1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


# remap's fixed point: 1/32-px map steps, 15-bit interpolation weights
_INTER_BITS = 5
_TAB = 1 << _INTER_BITS
_COEF_BITS = 15


def undistort_map(K, dist, H: int, W: int) -> Tuple[np.ndarray, np.ndarray]:
    """The remap taps (bilinear_taps) of cv2.undistort(img, K, dist) on an
    (H, W) image, under BORDER_CONSTANT 0."""
    K = np.asarray(K, np.float64)
    d = np.zeros(8)
    dist = np.asarray(dist, np.float64).reshape(-1)
    if dist.size not in (4, 5, 8):
        raise ValueError(f"distortion needs 4, 5 or 8 coefficients, got "
                         f"{dist.size}")
    d[:dist.size] = dist
    k1, k2, p1, p2, k3, k4, k5, k6 = d
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    # cv2.undistort maps stripes of rows, each with the new camera's
    # principal point moved up by the stripe's first row
    stripe = min(max(1, (1 << 12) // max(W, 1)), H)
    iu = np.empty((H, W), np.int64)
    iv = np.empty((H, W), np.int64)
    j = np.arange(W, dtype=np.float64)
    for y0 in range(0, H, stripe):
        rows = min(stripe, H - y0)
        Ar = K.copy()
        Ar[1, 2] = v0 - y0
        ir = np.linalg.inv(Ar).reshape(-1)
        i = np.arange(rows, dtype=np.float64)[:, None]
        _x = i * ir[1] + ir[2] + j * ir[0]
        _y = i * ir[4] + ir[5] + j * ir[3]
        _w = i * ir[7] + ir[8] + j * ir[6]
        w = 1.0 / _w
        x, y = _x * w, _y * w
        x2, y2 = x * x, y * y
        r2 = x2 + y2
        _2xy = 2 * x * y
        kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (
            1 + ((k6 * r2 + k5) * r2 + k4) * r2)
        xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)
        yd = y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy
        u = fx * xd + u0
        v = fy * yd + v0
        iu[y0:y0 + rows] = np.rint(u * _TAB).astype(np.int64)
        iv[y0:y0 + rows] = np.rint(v * _TAB).astype(np.int64)
    return bilinear_taps(iu, iv, H, W)


def bilinear_taps(iu: np.ndarray, iv: np.ndarray, H: int, W: int):
    """remap INTER_LINEAR's taps for source coordinates in 1/32 px
    (integer (h, w) arrays iu = cols * 32, iv = rows * 32, rounded as
    cvRound does) on an (H, W) source: (idx, w), each (4, h*w), the
    flat source pixel of each tap and its 15-bit weight; a tap outside the
    source gets weight 0 (BORDER_CONSTANT 0)."""
    sx, sy = iu >> _INTER_BITS, iv >> _INTER_BITS
    ax, ay = iu & (_TAB - 1), iv & (_TAB - 1)
    # the bilinear table of remap: (1-ay)(1-ax), (1-ay)ax, ay(1-ax), ay ax
    # on 1/32 steps, times 2^15 (exact: multiples of 32)
    scale = (1 << _COEF_BITS) // (_TAB * _TAB)
    idxs, ws = [], []
    for dy, dx, wy, wx in ((0, 0, _TAB - ay, _TAB - ax), (0, 1, _TAB - ay, ax),
                           (1, 0, ay, _TAB - ax), (1, 1, ay, ax)):
        tx, ty = sx + dx, sy + dy
        w = np.where((tx >= 0) & (tx < W) & (ty >= 0) & (ty < H),
                     wy * wx * scale, 0)
        idxs.append((np.clip(ty, 0, H - 1) * W
                     + np.clip(tx, 0, W - 1)).reshape(-1))
        ws.append(w.reshape(-1))
    return np.stack(idxs), np.stack(ws).astype(np.int32)


def remap_linear(img: np.ndarray, taps) -> np.ndarray:
    """Apply undistort_map's taps to an (H, W) or (H, W, C) uint8 image."""
    idx, w = taps
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"remap_linear takes uint8 images, got {img.dtype}")
    H, W = img.shape[:2]
    if idx.shape[1] != H * W or idx.max() >= H * W:
        raise ValueError(f"taps of {idx.shape[1]} pixels for an image of "
                         f"{H}x{W}")
    flat = img.reshape(H * W, -1).astype(np.int32)
    acc = np.zeros(flat.shape, np.int32)
    for k in range(4):
        acc += flat[idx[k]] * w[k][:, None]
    out = (acc + (1 << (_COEF_BITS - 1))) >> _COEF_BITS
    return np.clip(out, 0, 255).astype(np.uint8).reshape(img.shape)


def undistort(img: np.ndarray, K, dist) -> np.ndarray:
    """cv2.undistort(img, K, dist) for a uint8 image."""
    return remap_linear(img, undistort_map(K, dist, *np.shape(img)[:2]))
