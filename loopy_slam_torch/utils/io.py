"""Checkpointing and point-cloud export (port of loopy_slam_tpu/utils/io.py):
pickle checkpoints of numpy trees, binary PLY point clouds."""

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


def save_checkpoint(path: str, payload: Dict[str, Any]):
    """Pickle checkpoint of numpy trees + metadata."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=4)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint this program wrote (pickle: trusted files only)."""
    with open(path, "rb") as f:
        return pickle.load(f)
