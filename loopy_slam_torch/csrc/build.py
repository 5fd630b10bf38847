"""Build and load the port's native libraries.

The CUDA sources in this directory are compiled at first use with nvcc
into a shared library with a plain C interface, loaded with ctypes (no
PyTorch headers, so a build takes seconds). The host mesh rasterizer
(`raster_depth.cpp`) is a library of its own, built with g++, so that it
builds wherever a C++ compiler is, the CPU tests' machine included. Each
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
# -fmad=false: no fused multiply-add contraction, so distances round like
# the reference's separate multiply and add (the intrinsics in the source
# already pin the hot expression; this covers the rest of the file)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# the host rasterizer: the JAX package's g++ flags for the same source, and
# no fused multiply-adds on any host
RASTER_SOURCE = "raster_depth.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_raster_lib: Optional[ctypes.CDLL] = None
BUILD_LOG: dict = {}  # last build: {"path", "seconds", "log"} (empty if loaded)


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


def load_raster_library() -> ctypes.CDLL:
    """Build (if needed) and load the host rasterizer, once per process;
    raises when g++ is missing or the build fails."""
    global _raster_lib
    with _lock:
        if _raster_lib is None:
            gxx = shutil.which("g++")
            if gxx is None:
                raise FileNotFoundError(
                    "g++ not found on PATH; the mesh rasterizer of the "
                    "reconstruction metrics is built from source at first "
                    "use")
            lib = ctypes.CDLL(_compile(gxx, (RASTER_SOURCE,), GXX_FLAGS,
                                       "loopy_raster", {}))
            vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            fn = lib.raster_depth
            fn.argtypes = [vp, ci, vp, ci, vp, ci, ci, cd, cd, cd, cd, vp]
            fn.restype = ci
            _raster_lib = lib
        return _raster_lib


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
