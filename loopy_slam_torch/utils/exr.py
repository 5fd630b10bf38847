"""Minimal OpenEXR scanline codec in numpy and zlib (the port's copy of
loopy_slam_tpu/utils/exr.py; no OpenEXR/Imath packages).

Reads what RGB-D depth dumps use (CoFusion's depth_noise/*.exr): single-part
scanline files, NONE / ZIPS / ZIP compression, HALF / FLOAT / UINT
channels, xSampling == ySampling == 1, increasing-y line order. Anything
else raises with the file's name and the reason. `read_exr_depth` is the
reference's readEXR_onlydepth: the 'Y' channel as float32, or None.
`write_exr` writes the same subset (fixtures and exports).

Layout: the OpenEXR 2.x file format specification (magic, attribute list,
chunk offset table, per-block [y, size, data] chunks; the ZIP predictor is
a byte de-interleave plus a delta of 128, then zlib).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

_MAGIC = b"\x76\x2f\x31\x01"
_PIXEL_DTYPE = {0: np.dtype(np.uint32), 1: np.dtype(np.float16),
                2: np.dtype(np.float32)}
_PIXEL_CODE = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1,
               np.dtype(np.float32): 2}
_COMPRESSION_LINES = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP
_COMPRESSION_NAMES = {0: "NONE", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ",
                      5: "PXR24", 6: "B44", 7: "B44A", 8: "DWAA", 9: "DWAB"}


def _read_cstr(buf: bytes, off: int) -> Tuple[bytes, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end], end + 1


def _zip_undo_predictor(data: bytes) -> bytes:
    b = np.frombuffer(data, np.uint8)
    # delta decode: c[i] = c[i-1] + b[i] - 128
    c = ((np.cumsum(b.astype(np.int64) - 128) + 128) & 0xFF).astype(np.uint8)
    # de-interleave: first half -> even positions, second half -> odd
    out = np.empty_like(c)
    half = (len(c) + 1) // 2
    out[0::2] = c[:half]
    out[1::2] = c[half:]
    return out.tobytes()


def _zip_apply_predictor(data: bytes) -> bytes:
    b = np.frombuffer(data, np.uint8)
    half = (len(b) + 1) // 2
    t = np.concatenate([b[0::2], b[1::2]])
    d = t.astype(np.int64)
    d[1:] = d[1:] - t[:-1].astype(np.int64) + 128
    return (d & 0xFF).astype(np.uint8).tobytes()


def read_exr(path: str) -> Dict[str, np.ndarray]:
    """Read all channels of a single-part scanline EXR -> {name: (H,W)}."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    version = struct.unpack("<I", buf[4:8])[0]
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    if version & 0x1000 or version & 0x800:
        raise ValueError(f"{path}: multi-part/deep EXR not supported")

    off = 8
    channels = []  # (name, dtype, xs, ys)
    compression = None
    data_window = None
    while True:
        name, off = _read_cstr(buf, off)
        if name == b"":
            break
        atype, off = _read_cstr(buf, off)
        size = struct.unpack_from("<i", buf, off)[0]
        off += 4
        payload = buf[off:off + size]
        off += size
        if name == b"channels":
            p = 0
            while payload[p:p + 1] != b"\x00":
                cname, p = _read_cstr(payload, p)
                ptype, xs, ys = struct.unpack_from("<i4xii", payload, p)
                p += 16
                if ptype not in _PIXEL_DTYPE:
                    raise ValueError(f"{path}: unknown pixel type {ptype}")
                if xs != 1 or ys != 1:
                    raise ValueError(f"{path}: subsampled channels "
                                     "not supported")
                channels.append((cname.decode(), _PIXEL_DTYPE[ptype]))
        elif name == b"compression":
            compression = payload[0]
        elif name == b"dataWindow":
            data_window = struct.unpack("<4i", payload)
    if compression not in _COMPRESSION_LINES:
        raise ValueError(
            f"{path}: compression "
            f"{_COMPRESSION_NAMES.get(compression, compression)} not "
            "supported (supported: NONE, ZIPS, ZIP)")
    xmin, ymin, xmax, ymax = data_window
    W, H = xmax - xmin + 1, ymax - ymin + 1
    lines_per_block = _COMPRESSION_LINES[compression]
    n_blocks = -(-H // lines_per_block)
    # channels are stored in alphabetical order within each scanline
    chan_sorted = sorted(channels, key=lambda c: c[0])
    row_bytes = [W * dt.itemsize for _, dt in chan_sorted]

    off += 8 * n_blocks  # skip offset table; chunks follow contiguously
    out = {cname: np.empty((H, W), dt) for cname, dt in chan_sorted}
    for _ in range(n_blocks):
        y, size = struct.unpack_from("<ii", buf, off)
        off += 8
        raw = buf[off:off + size]
        off += size
        y0 = y - ymin
        n_lines = min(lines_per_block, H - y0)
        expect = sum(row_bytes) * n_lines
        if compression != 0 and size < expect:
            raw = _zip_undo_predictor(zlib.decompress(raw))
        if len(raw) != expect:
            raise ValueError(f"{path}: block at y={y} has {len(raw)} bytes, "
                             f"expected {expect}")
        p = 0
        for line in range(n_lines):
            for (cname, dt), rb in zip(chan_sorted, row_bytes):
                out[cname][y0 + line] = np.frombuffer(
                    raw, dt, count=W, offset=p)
                p += rb
    return out


def read_exr_depth(path: str) -> Optional[np.ndarray]:
    """Depth ('Y') channel as float32, or None if the file has no Y channel
    — exact semantics of the reference readEXR_onlydepth."""
    chans = read_exr(path)
    if "Y" not in chans:
        return None
    return np.ascontiguousarray(chans["Y"].astype(np.float32))


def write_exr(path: str, channels: Dict[str, np.ndarray],
              compression: str = "ZIP") -> None:
    """Write a single-part scanline EXR (fixture/export use)."""
    comp_code = {"NONE": 0, "ZIPS": 2, "ZIP": 3}[compression]
    shapes = {c.shape for c in channels.values()}
    if len(shapes) != 1:
        raise ValueError("all channels must share one shape")
    H, W = shapes.pop()
    chan_sorted = sorted(channels.items())
    chan_sorted = [(n, np.ascontiguousarray(c)) for n, c in chan_sorted]

    def attr(name: bytes, atype: bytes, payload: bytes) -> bytes:
        return (name + b"\x00" + atype + b"\x00"
                + struct.pack("<i", len(payload)) + payload)

    chpayload = b""
    for nm, arr in chan_sorted:
        code = _PIXEL_CODE[arr.dtype]
        chpayload += (nm.encode() + b"\x00"
                      + struct.pack("<iBBBBii", code, 0, 0, 0, 0, 1, 1))
    chpayload += b"\x00"
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = (
        attr(b"channels", b"chlist", chpayload)
        + attr(b"compression", b"compression", bytes([comp_code]))
        + attr(b"dataWindow", b"box2i", box)
        + attr(b"displayWindow", b"box2i", box)
        + attr(b"lineOrder", b"lineOrder", b"\x00")
        + attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        + attr(b"screenWindowCenter", b"v2f", struct.pack("<2f", 0, 0))
        + attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        + b"\x00")

    lines_per_block = _COMPRESSION_LINES[comp_code]
    n_blocks = -(-H // lines_per_block)
    chunks = []
    for bi in range(n_blocks):
        y0 = bi * lines_per_block
        n_lines = min(lines_per_block, H - y0)
        raw = b"".join(
            arr[y0 + line].tobytes()
            for line in range(n_lines) for _, arr in chan_sorted)
        if comp_code != 0:
            comp = zlib.compress(_zip_apply_predictor(raw))
            data = comp if len(comp) < len(raw) else raw
        else:
            data = raw
        chunks.append(struct.pack("<ii", y0, len(data)) + data)

    base = 8 + len(header) + 8 * n_blocks
    offsets, pos = [], base
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    with open(path, "wb") as f:
        f.write(_MAGIC + struct.pack("<I", 2) + header)
        f.write(struct.pack(f"<{n_blocks}q", *offsets))
        for c in chunks:
            f.write(c)
