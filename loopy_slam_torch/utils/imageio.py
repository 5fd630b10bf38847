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
  * `read_jpeg`: baseline (sequential Huffman, 8-bit) JPEGs, gray or
    YCbCr with 4:2:0, 4:2:2 or 4:4:4 sampling, with or without restart
    markers, decoded as OpenCV's `imread` decodes them through
    libjpeg-turbo's defaults (the "islow" integer IDCT, "fancy" chroma
    upsampling, fixed-point YCbCr->RGB): the same pixels, RGB order.
    The markers are parsed here; the scan is decoded by
    `csrc/jpeg_huffman.cpp` (g++, built at first use). Anything else
    (progressive or arithmetic coding, 12-bit samples, CMYK or Adobe RGB,
    other sampling factors, an EXIF orientation other than 1, which
    imread would apply, a truncated or corrupt stream) raises with the
    file's name and the reason.
  * `write_jpeg`: a baseline 4:2:0 JPEG with the standard tables scaled by
    `quality`, as libjpeg-turbo's compressor writes it with OpenCV's
    `imwrite` settings.
  * `resize_linear`: `cv2.resize(img, (W, H))` (INTER_LINEAR) on float32.
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


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

# zigzag position -> natural (row-major) position
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# ITU-T T.81 Annex K: the example quantization tables (natural order) and
# Huffman tables (code counts per length, symbols), which libjpeg uses
_STD_QUANT = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
              14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
              18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
              92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112,
              100, 103, 99]),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
             + [99] * 32))
_STD_HUFF = (  # luminance DC, luminance AC, chrominance DC, chrominance AC
    ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
        "535455565758595a636465666768696a737475767778797a838485868788898a"
        "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
        "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9"
        "fa")),
    ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")),
)

_JPEG_ERRORS = {
    -1: "truncated or corrupt scan data (it ends inside an MCU)",
    -2: "corrupt scan data (a bit pattern that is no Huffman code)",
    -3: "a restart marker is missing or out of order",
    -4: "corrupt scan data (a run past the 64th coefficient)",
    -5: "a Huffman table overflows its code space",
}
_PROGRESSIVE = {0xC2, 0xC6, 0xCA, 0xCE}
_ARITHMETIC = {0xC9, 0xCA, 0xCB, 0xCC, 0xCD, 0xCE, 0xCF}
_LOSSLESS = {0xC3, 0xC5, 0xC7}


def _exif_orientation(seg: bytes):
    """The orientation tag (0x0112) of an APP1 Exif segment's IFD0, or
    None."""
    tiff = seg[6:]
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return None
    e = "<" if tiff[:2] == b"II" else ">"
    off = struct.unpack(e + "I", tiff[4:8])[0]
    if off + 2 > len(tiff):
        return None
    n = struct.unpack(e + "H", tiff[off:off + 2])[0]
    for k in range(n):
        ent = tiff[off + 2 + 12 * k:off + 14 + 12 * k]
        if len(ent) < 12:
            return None
        tag, typ = struct.unpack(e + "HH", ent[:4])
        if tag == 0x0112 and typ == 3:
            return struct.unpack(e + "H", ent[8:10])[0]
    return None


def read_jpeg(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a baseline JPEG, equal to cv2.imread(path)
    with its channels reversed (gray files replicated to three
    channels)."""
    import ctypes

    from ..csrc.build import load_jpeg_library

    with open(path, "rb") as f:
        data = f.read()

    def fail(why: str):
        raise ValueError(f"{path}: {why}")

    if data[:2] != b"\xff\xd8":
        fail("not a JPEG file (no SOI marker)")
    pos, n = 2, len(data)
    qt, huff, frame, restart = {}, {}, None, 0
    jfif, adobe = False, None
    while True:
        if pos >= n or data[pos] != 0xFF:
            fail(f"truncated or corrupt header (no marker at byte {pos})")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos + 3 > n:
            fail("truncated header")
        m = data[pos]
        L = int.from_bytes(data[pos + 1:pos + 3], "big")
        seg = data[pos + 3:pos + 1 + L]
        if m == 0xD9:
            fail("no scan before the EOI marker")
        if m == 0xD8 or 0xD0 <= m <= 0xD7 or m == 0x01:
            fail(f"unexpected marker 0x{m:02X} in the header")
        if L < 2 or len(seg) != L - 2:
            fail(f"truncated 0x{m:02X} segment")
        pos += 1 + L
        if m in _PROGRESSIVE:
            fail("progressive JPEGs are not supported (baseline only)")
        if m in _ARITHMETIC:
            fail("arithmetic-coded JPEGs are not supported (baseline only)")
        if m in _LOSSLESS:
            fail("lossless or hierarchical JPEGs are not supported "
                 "(baseline only)")
        if m == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xE1 and seg[:6] == b"Exif\x00\x00":
            o = _exif_orientation(seg)
            if o is not None and o not in (0, 1):
                fail(f"EXIF orientation {o} (imread would rotate the image; "
                     "only orientation 1 is supported)")
        elif m == 0xEE and seg[:5] == b"Adobe":
            adobe = seg[11] if len(seg) >= 12 else 0
        elif 0xE0 <= m <= 0xEF or m == 0xFE:
            pass
        elif m == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq != 0:
                    fail("16-bit quantization tables are not supported")
                if i + 65 > len(seg):
                    fail("truncated DQT segment")
                tab = np.zeros(64, np.uint16)
                tab[_NATURAL] = np.frombuffer(seg[i + 1:i + 65], np.uint8)
                qt[tq] = tab
                i += 65
        elif m == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = np.frombuffer(seg[i + 1:i + 17], np.uint8)
                nv = int(bits.sum())
                if len(bits) != 16 or nv > 256 or i + 17 + nv > len(seg):
                    fail("corrupt DHT segment")
                vals = np.zeros(256, np.uint8)
                vals[:nv] = np.frombuffer(seg[i + 17:i + 17 + nv], np.uint8)
                huff[(tc, th)] = (bits.copy(), vals)
                i += 17 + nv
        elif m == 0xDD:
            if len(seg) < 2:
                fail("corrupt DRI segment")
            restart = int.from_bytes(seg[:2], "big")
        elif m in (0xC0, 0xC1):
            if len(seg) < 6:
                fail("corrupt SOF segment")
            prec, H, W, nf = seg[0], *struct.unpack(">HH", seg[1:5]), seg[5]
            if prec != 8:
                fail(f"{prec}-bit samples are not supported (8-bit only)")
            if H == 0 or W == 0:
                fail("an image height or width of 0 (DNL) is not supported")
            if len(seg) < 6 + 3 * nf:
                fail("corrupt SOF segment")
            comps = [(seg[6 + 3 * k], seg[7 + 3 * k] >> 4,
                      seg[7 + 3 * k] & 15, seg[8 + 3 * k])
                     for k in range(nf)]
            frame = (H, W, comps)
        elif m == 0xDA:
            break
        else:
            fail(f"unsupported marker 0x{m:02X}")
    if frame is None:
        fail("no SOF0/SOF1 frame header before the scan")
    H, W, comps = frame
    nf = len(comps)
    ns = seg[0] if seg else 0
    if len(seg) < 4 + 2 * ns:
        fail("corrupt SOS segment")
    scomp = [(seg[1 + 2 * k], seg[2 + 2 * k] >> 4, seg[2 + 2 * k] & 15)
             for k in range(ns)]
    ss, se, a = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    if (ss, se, a) != (0, 63, 0):
        fail("not a baseline sequential scan")
    if [c[0] for c in scomp] != [c[0] for c in comps]:
        fail("a scan that does not hold every component in frame order "
             "(multi-scan files are not supported)")
    if nf == 3:
        if adobe == 0 or (not jfif and adobe is None
                          and [c[0] for c in comps] == [82, 71, 66]):
            fail("RGB-coded JPEGs are not supported (YCbCr or gray only)")
        hmax = max(c[1] for c in comps)
        vmax = max(c[2] for c in comps)
        for _, h, v, _ in comps:
            if hmax % h or vmax % v or (hmax // h, vmax // v) not in (
                    (1, 1), (2, 1), (2, 2)):
                fail(f"sampling factors {[(c[1], c[2]) for c in comps]} are "
                     "not supported (4:2:0, 4:2:2 or 4:4:4)")
    elif nf != 1:
        fail(f"{nf}-component (CMYK or other) JPEGs are not supported")
    q = np.zeros((nf, 64), np.uint16)
    dcb = np.zeros((nf, 16), np.uint8)
    acb = np.zeros((nf, 16), np.uint8)
    dcv = np.zeros((nf, 256), np.uint8)
    acv = np.zeros((nf, 256), np.uint8)
    for k, ((_, _, _, tq), (_, td, ta)) in enumerate(zip(comps, scomp)):
        if tq not in qt or (0, td) not in huff or (1, ta) not in huff:
            fail("a component refers to a missing table")
        q[k] = qt[tq]
        dcb[k], dcv[k] = huff[(0, td)]
        acb[k], acv[k] = huff[(1, ta)]
    hs = np.array([c[1] for c in comps], np.int32)
    vs = np.array([c[2] for c in comps], np.int32)
    scan = data[pos:]
    out = np.empty((H, W, 3), np.uint8)
    end = ctypes.c_int64(0)
    lib = load_jpeg_library()
    rc = lib.jpeg_decode(
        ctypes.c_char_p(scan), len(scan), W, H, nf, hs.ctypes.data,
        vs.ctypes.data, q.ctypes.data, dcb.ctypes.data, dcv.ctypes.data,
        acb.ctypes.data, acv.ctypes.data, restart, out.ctypes.data,
        ctypes.byref(end))
    if rc != 0:
        fail(_JPEG_ERRORS.get(rc, f"decoder error {rc}"))
    tail = scan[end.value:end.value + 2]
    if tail != b"\xff\xd9":
        if len(tail) < 2:
            fail("truncated file (no EOI marker after the scan)")
        fail(f"marker 0x{tail[1]:02X} after the first scan (multi-scan "
             "files are not supported)")
    return out


def _quant_tables(quality: int):
    """jcparam.c: the standard tables scaled for `quality`, clamped to
    1..255 (baseline)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [np.clip((t * scale + 50) // 100, 1, 255).astype(np.uint16)
            for t in _STD_QUANT]


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 95) -> None:
    """An (H, W, 3) uint8 RGB image as a baseline 4:2:0 JFIF file with the
    standard tables scaled by `quality`, the file libjpeg-turbo writes for
    cv2.imwrite(path, bgr, [IMWRITE_JPEG_QUALITY, quality])."""
    import ctypes

    from ..csrc.build import load_jpeg_library

    img = np.ascontiguousarray(rgb)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_jpeg takes (H, W, 3) uint8 RGB, got "
                         f"{img.dtype} {img.shape}")
    H, W = img.shape[:2]
    if not (0 < H < 65536 and 0 < W < 65536):
        raise ValueError(f"write_jpeg: a {H}x{W} image does not fit a JPEG")
    qts = _quant_tables(quality)
    bits = np.zeros((4, 16), np.uint8)
    vals = np.zeros((4, 256), np.uint8)
    for k, (b, v) in enumerate(_STD_HUFF):
        bits[k] = b
        vals[k, :len(v)] = np.frombuffer(v, np.uint8)
    cap = 2 * H * W * 3 + 65536
    buf = np.empty(cap, np.uint8)
    length = ctypes.c_int64(0)
    rc = load_jpeg_library().jpeg_encode(
        img.ctypes.data, W, H, qts[0].ctypes.data, qts[1].ctypes.data,
        bits.ctypes.data, vals.ctypes.data, buf.ctypes.data, cap,
        ctypes.byref(length))
    if rc != 0:
        raise RuntimeError(f"{path}: JPEG encoder error {rc}")

    def segment(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    head = [b"\xff\xd8",
            segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for k, t in enumerate(qts):
        head.append(segment(0xDB, bytes([k]) + t[_NATURAL].astype(
            np.uint8).tobytes()))
    head.append(segment(0xC0, struct.pack(">BHHB", 8, H, W, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls_id, (b, v) in zip((0x00, 0x10, 0x01, 0x11), _STD_HUFF):
        head.append(segment(0xC4, bytes([cls_id]) + bytes(b) + v))
    head.append(segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11,
                                     0, 63, 0])))
    with open(path, "wb") as f:
        f.write(b"".join(head))
        f.write(buf[:length.value].tobytes())
        f.write(b"\xff\xd9")


# ---------------------------------------------------------------------------
# Resize
# ---------------------------------------------------------------------------

def _linear_taps(n_src: int, n_dst: int, scale: float, clamp_weight: bool):
    """OpenCV resize's INTER_LINEAR source index and weight of each output
    position: f = float((d + 0.5) * scale - 0.5), i = floor(f), w = f - i
    in float32. With clamp_weight (the horizontal taps), an index left of
    the source takes i = 0, w = 0 and one at or past the last sample
    i = n - 1, w = 0; the vertical taps keep their weight and clamp their
    rows when they are read."""
    f = ((np.arange(n_dst, dtype=np.float64) + 0.5) * scale - 0.5
         ).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    w = f - i.astype(np.float32)
    if clamp_weight:
        lo = i < 0
        hi = i >= n_src - 1
        i = np.where(lo, 0, np.where(hi, n_src - 1, i))
        w = np.where(lo | hi, np.float32(0), w).astype(np.float32)
    return i, w


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, size) with INTER_LINEAR for a float32 (H, W) or
    (H, W, C) image; size is (width, height), as cv2 takes it. The
    horizontal pass, then the vertical one, each a float32 sum of two
    float32 products (no fused multiply-add), with OpenCV's taps: edge
    columns replicate the border sample, edge rows interpolate between
    clamped rows. An exact 2x shrink takes OpenCV's 2x2 average instead,
    as cv2.resize does, summed as its scalar code sums 3-channel images
    (its one- and four-channel SIMD code groups the terms in pairs).
    cv2.resize with Intel IPP enabled rounds differently (within 1e-4 on
    [0, 1] color)."""
    img = np.asarray(img)
    if img.dtype != np.float32:
        raise TypeError(f"resize_linear takes float32 images, got {img.dtype}")
    W2, H2 = int(size[0]), int(size[1])
    H, W = img.shape[:2]
    if (W2, H2) == (W, H):
        return img.copy()
    src = img.reshape(H, W, -1)
    sx, sy = W / W2, H / H2
    if sx == 2.0 and sy == 2.0:
        a, b = src[0::2, 0::2], src[0::2, 1::2]
        c, d = src[1::2, 0::2], src[1::2, 1::2]
        out = (((a + b) + c) + d) * np.float32(0.25)
        return out.reshape((H2, W2) + img.shape[2:])
    xi, xw = _linear_taps(W, W2, sx, True)
    xn = np.minimum(xi + 1, W - 1)
    a0 = (np.float32(1) - xw)[None, :, None]
    a1 = xw[None, :, None]
    rows = src[:, xi] * a0 + src[:, xn] * a1
    yi, yw = _linear_taps(H, H2, sy, False)
    r0 = rows[np.clip(yi, 0, H - 1)]
    r1 = rows[np.clip(yi + 1, 0, H - 1)]
    out = r0 * (np.float32(1) - yw)[:, None, None] \
        + r1 * yw[:, None, None]
    return out.astype(np.float32).reshape((H2, W2) + img.shape[2:])
