"""Build and load the port's native libraries.

The CUDA sources in this directory are compiled at first use with nvcc
into shared libraries with a plain C interface (the k-NN kernel's, and the
tracker's render kernels'), loaded with ctypes (no
PyTorch headers, so a build takes seconds). The host mesh rasterizer
(`raster_depth.cpp`), the PNG reader's unfilter (`png_unfilter.cpp`) and
the JPEG codec's entropy coding (`jpeg_huffman.cpp`) are libraries of
their own, built with g++, so that they build wherever a
C++ compiler is, the CPU tests' machine included. Each
library lands in `loopy_slam_torch/_build/`, named by a hash of its
sources, its flags and the compiler's version, so a changed source or flag
rebuilds and an unchanged one loads the existing file. A failed build
raises. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("knn_select.cu",)
# the tracker's render kernels: a library of their own, so that a change to
# either source leaves the other's library as it is
TRACK_SOURCES = ("track_render.cu",)
# -fmad=false: no fused multiply-add contraction, so distances round like
# the reference's separate multiply and add (the intrinsics in the source
# already pin the hot expression; this covers the rest of the file)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# the host libraries: the JAX package's g++ flags for the rasterizer's
# source, and no fused multiply-adds on any host
RASTER_SOURCE = "raster_depth.cpp"
PNG_SOURCE = "png_unfilter.cpp"
JPEG_SOURCE = "jpeg_huffman.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_track_lib: Optional[ctypes.CDLL] = None
_host_libs: dict = {}  # source -> loaded g++ library
BUILD_LOG: dict = {}  # last build: {"path", "seconds", "log"} (empty if loaded)
TRACK_BUILD_LOG: dict = {}  # the same, of the render kernels' library


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise FileNotFoundError(
            "nvcc not found on PATH or under CUDA_HOME; the port's CUDA "
            "kernels are built from source at first use")
    return path


def _library_path(compiler: str, sources, flags, stem: str) -> str:
    h = hashlib.sha256()
    for name in sources:
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    version = subprocess.run([compiler, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h.update(version.encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def _compile(compiler: str, sources, flags, stem: str, log: dict) -> str:
    """Compile `sources` into a shared library if none for them exists;
    return its path."""
    import time

    path = _library_path(compiler, sources, flags, stem)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [compiler, *flags, "-o", tmp,
             *[os.path.join(_HERE, s) for s in sources]],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed "
                               f"({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    log.update(path=path, seconds=time.perf_counter() - t0,
               log=proc.stdout + proc.stderr)
    return path


def build_library() -> str:
    """Compile the CUDA sources if no library for them exists; return its
    path."""
    return _compile(nvcc_path(), SOURCES, NVCC_FLAGS, "loopy_kernels",
                    BUILD_LOG)


def build_track_library() -> str:
    """Compile the tracker's render kernels if no library for them exists;
    return its path."""
    return _compile(nvcc_path(), TRACK_SOURCES, NVCC_FLAGS, "loopy_track",
                    TRACK_BUILD_LOG)


def _load_host_library(source: str, stem: str, what: str,
                       functions: dict) -> ctypes.CDLL:
    """Build (if needed) and load the g++ library of `source`, once per
    process, declaring its C entry points ({name: argtypes}, each
    returning int); raises when g++ is missing or the build fails."""
    with _lock:
        if source not in _host_libs:
            gxx = shutil.which("g++")
            if gxx is None:
                raise FileNotFoundError(
                    f"g++ not found on PATH; {what} is built from source at "
                    "first use")
            lib = ctypes.CDLL(_compile(gxx, (source,), GXX_FLAGS, stem, {}))
            for fn_name, argtypes in functions.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _host_libs[source] = lib
        return _host_libs[source]


def load_raster_library() -> ctypes.CDLL:
    """The host mesh rasterizer of the reconstruction metrics."""
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    return _load_host_library(
        RASTER_SOURCE, "loopy_raster",
        "the mesh rasterizer of the reconstruction metrics",
        {"raster_depth": [vp, ci, vp, ci, vp, ci, ci, cd, cd, cd, cd, vp]})


def load_png_library() -> ctypes.CDLL:
    """The PNG reader's scanline unfilter."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return _load_host_library(PNG_SOURCE, "loopy_png",
                              "the PNG reader's unfilter",
                              {"png_unfilter": [vp, vp, ci, ci, ci]})


def load_jpeg_library() -> ctypes.CDLL:
    """The JPEG reader's and writer's scan coding (jpeg_decode,
    jpeg_encode)."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return _load_host_library(
        JPEG_SOURCE, "loopy_jpeg", "the JPEG codec's scan coding",
        {"jpeg_decode": [vp, cl, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, ci,
                         vp, vp],
         "jpeg_encode": [vp, ci, ci, vp, vp, vp, vp, vp, cl, vp]})


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            fn = lib.knn_select_launch
            vp, ci = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [vp, vp, vp, vp, ctypes.c_float, vp, vp, vp, vp,
                           ci, ci, ci, ci, ci, vp]
            fn.restype = ci
            _lib = lib
        return _lib


def load_track_library() -> ctypes.CDLL:
    """Build (if needed) and load the tracker's render kernels
    (track_render.cu), once per process."""
    global _track_lib
    with _lock:
        if _track_lib is None:
            lib = ctypes.CDLL(build_track_library())
            vp, ci, cf, cl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                              ctypes.c_long)
            fwd = lib.track_render_forward
            fwd.argtypes = [vp] * 8 + [cf] + [vp] * 6 + [ci] * 7 + [cf, vp]
            fwd.restype = ci
            bwd = lib.track_render_backward
            bwd.argtypes = ([vp] * 8 + [cf, vp, cl, vp, cl, cl, vp, vp]
                            + [ci] * 7 + [cf, vp])
            bwd.restype = ci
            lib.track_render_save_floats.argtypes = [ci, ci]
            lib.track_render_save_floats.restype = cl
            _track_lib = lib
        return _track_lib
