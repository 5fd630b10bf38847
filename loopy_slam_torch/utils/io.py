"""Checkpointing and point-cloud export (port of loopy_slam_tpu/utils/io.py):
pickle checkpoints of numpy trees, binary PLY point clouds and meshes."""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np


def write_ply_points(path: str, points: np.ndarray, colors=None):
    """Binary little-endian PLY of a point set; colors in [0,1] or uint8."""
    n = points.shape[0]
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}",
                  "property float x", "property float y", "property float z"]
        if colors is not None:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        header += ["end_header", ""]
        f.write("\n".join(header).encode())
        if colors is None:
            f.write(points.astype("<f4").tobytes())
        else:
            c = colors
            if c.dtype != np.uint8:
                c = np.clip(c * (255.0 if c.max() <= 1.0 + 1e-6 else 1.0),
                            0, 255).astype(np.uint8)
            rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                     ("r", "u1"), ("g", "u1"), ("b", "u1")])
            rec["x"], rec["y"], rec["z"] = points.T.astype(np.float32)
            rec["r"], rec["g"], rec["b"] = c.T
            f.write(rec.tobytes())


def write_ply_mesh(path: str, verts: np.ndarray, faces: np.ndarray,
                   colors=None):
    """Binary PLY triangle mesh."""
    n, m = verts.shape[0], faces.shape[0]
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}",
                  "property float x", "property float y", "property float z"]
        if colors is not None:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        header += [f"element face {m}",
                   "property list uchar int vertex_indices", "end_header", ""]
        f.write("\n".join(header).encode())
        if colors is None:
            f.write(verts.astype("<f4").tobytes())
        else:
            c = colors
            if c.dtype != np.uint8:
                c = np.clip(c * 255.0, 0, 255).astype(np.uint8)
            rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                     ("r", "u1"), ("g", "u1"), ("b", "u1")])
            rec["x"], rec["y"], rec["z"] = verts.T.astype(np.float32)
            rec["r"], rec["g"], rec["b"] = c.T
            f.write(rec.tobytes())
        frec = np.zeros(m, dtype=[("n", "u1"), ("i", "<i4", (3,))])
        frec["n"] = 3
        frec["i"] = faces.astype(np.int32)
        f.write(frec.tobytes())


def read_ply_mesh(path: str):
    """Read a binary PLY mesh written by write_ply_mesh (round-trip use)."""
    with open(path, "rb") as f:
        line = f.readline()
        n = m = 0
        has_color = False
        while True:
            line = f.readline().decode().strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("element face"):
                m = int(line.split()[-1])
            elif line.startswith("property uchar red"):
                has_color = True
            elif line == "end_header":
                break
        if has_color:
            rec = np.frombuffer(f.read(n * 15), dtype=[
                ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                ("r", "u1"), ("g", "u1"), ("b", "u1")], count=n)
            verts = np.stack([rec["x"], rec["y"], rec["z"]], -1)
            colors = np.stack([rec["r"], rec["g"], rec["b"]], -1)
        else:
            verts = np.frombuffer(f.read(n * 12), dtype="<f4").reshape(n, 3)
            colors = None
        frec = np.frombuffer(f.read(m * 13), dtype=[("n", "u1"),
                                                    ("i", "<i4", (3,))],
                             count=m)
        return np.array(verts), np.array(frec["i"]), (
            None if colors is None else np.array(colors))


def save_checkpoint(path: str, payload: Dict[str, Any]):
    """Pickle checkpoint of numpy trees + metadata."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=4)


class _Unpickler(pickle.Unpickler):
    """Reads checkpoints of either package: a class of the JAX package
    (its submap `Fragment`) resolves to the port's class of the same
    module path, so loading never imports the JAX package."""

    def find_class(self, module, name):
        if module.split(".")[0] == "loopy_slam_tpu":
            module = "loopy_slam_torch" + module[len("loopy_slam_tpu"):]
        return super().find_class(module, name)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint written by this package or by the JAX package
    (pickle: trusted files only)."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()
