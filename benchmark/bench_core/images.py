"""The image writers the sequence writers use: frozen copies of
`loopy_slam_torch/utils/imageio.write_png` and `write_jpeg` (the bytes
libjpeg-turbo writes through OpenCV's imwrite), so that a later change to
the program's own writers cannot change the benchmark's inputs. The JPEG
scan coding is a copy of the program's `csrc/jpeg_huffman.cpp`
(`native/jpeg_codec.cpp`), built with g++ at first use into
`benchmark/_build/`, a fixed directory of the checkout, named by a hash of
its source, its flags and the compiler's version.
`tests/test_bench_frozen_inputs.py` holds both writers byte-equal to the
program's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import threading
import zlib

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SOURCE = os.path.join(_HERE, "native", "jpeg_codec.cpp")
_GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_lock = threading.Lock()
_jpeg_lib = None


def _load_jpeg_library() -> ctypes.CDLL:
    """Build (if no library for this source exists) and load the encoder,
    once per process; raises when g++ is missing or the build fails."""
    global _jpeg_lib
    with _lock:
        if _jpeg_lib is not None:
            return _jpeg_lib
        gxx = shutil.which("g++")
        if gxx is None:
            raise FileNotFoundError("g++ not found on PATH; the JPEG "
                                    "writer's scan coding is built at first "
                                    "use")
        h = hashlib.sha256()
        with open(_SOURCE, "rb") as f:
            h.update(f.read())
        h.update(" ".join(_GXX_FLAGS).encode())
        h.update(subprocess.run([gxx, "--version"], capture_output=True,
                                text=True, check=True).stdout.encode())
        path = os.path.join(BUILD_DIR, f"jpeg_codec-{h.hexdigest()[:16]}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run([gxx, *_GXX_FLAGS, "-o", tmp, _SOURCE],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                                       f"{proc.stdout}\n{proc.stderr}")
                os.replace(tmp, path)  # atomic: concurrent builds agree
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(path)
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.jpeg_encode.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp, cl, vp]
        lib.jpeg_encode.restype = ctypes.c_int
        _jpeg_lib = lib
        return lib


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
    rc = _load_jpeg_library().jpeg_encode(
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

