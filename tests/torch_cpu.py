"""CPU settings shared by the port's heavier parity tests, and a reader of
the uncompressed RGB PNGs the port's write_png writes."""

import contextlib
import struct
import zlib

import numpy as np

import pytest
import torch


@contextlib.contextmanager
def cpu_settings():
    """Flush subnormal floats, as XLA's CPU backend does (without it the
    backward of softplus100 and the Adam moments fill with subnormals and
    the port's CPU path runs several times slower), and cap torch at two
    intra-op threads so parallel test workers do not oversubscribe the
    cores. Both settings are restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_flush_denormal(True)
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        torch.set_flush_denormal(False)


@pytest.fixture
def torch_cpu():
    """cpu_settings() around one test."""
    with cpu_settings():
        yield


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of a PNG written by utils/imageio.write_png."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos, idat, W, H = 8, b"", 0, 0
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            W, H, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise ValueError(f"{path}: not an 8-bit RGB PNG")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, 1 + 3 * W)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered scanlines are not read")
    return rows[:, 1:].reshape(H, W, 3).copy()
