"""Build and load the port's CUDA kernels.

The sources in this directory are compiled at first use with nvcc into a
shared library with a plain C interface, loaded with ctypes (no PyTorch
headers, so a build takes seconds). The library lands in
`loopy_slam_torch/_build/`, named by a hash of the sources, the flags and
the compiler's version, so a changed source or flag rebuilds and an
unchanged one loads the existing file. nothing here runs at import time.
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

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
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


def _library_path(nvcc: str) -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h.update(version.encode())
    return os.path.join(BUILD_DIR, f"loopy_kernels-{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile the sources if no library for them exists; return its path."""
    import time

    nvcc = nvcc_path()
    path = _library_path(nvcc)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp,
             *[os.path.join(_HERE, s) for s in SOURCES]],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_LOG.update(path=path, seconds=time.perf_counter() - t0,
                     log=proc.stdout + proc.stderr)
    return path


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
