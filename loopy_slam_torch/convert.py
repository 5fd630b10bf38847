"""Carry decoder weights and map state between the JAX package and the port.

Both sides meet as numpy: the JAX decoder pytree maps leaf for leaf onto
the port's `Decoders` (same names, same (in, out) layout; the exposure MLP
`col.exposure` included), a JAX MapState/HashGrid maps onto the port's,
with the hash grid's packed `cell_data` layout unchanged (indices still
carry the _IDX_TAG bit), and a checkpoint's exposure state (the current
latent, each keyframe's and each mapped frame's) maps onto the session's.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from . import resolve_device
from .mapping.point_cloud import MapState
from .models.decoder import Decoders, _tree_of
from .ops.knn import HashGrid


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def decoders_from_numpy(tree: Dict[str, Any], device=None,
                        bf16_trunks: bool = True) -> Decoders:
    """JAX decoder pytree {"geo": ..., "col": ...} of numpy arrays ->
    Decoders on `device` (float32 copies; the card unless the caller asks
    for the CPU)."""
    device = resolve_device(device)
    t = _map_tree(lambda a: torch.as_tensor(np.array(a, np.float32),
                                            device=device), tree)
    return Decoders(t, bf16_trunks=bf16_trunks)


def decoders_to_numpy(dec: Decoders) -> Dict[str, Any]:
    """Decoders -> the JAX pytree layout of numpy arrays."""
    return {"geo": _map_tree(lambda p: p.detach().cpu().numpy().copy(),
                             _tree_of(dec.geo)),
            "col": _map_tree(lambda p: p.detach().cpu().numpy().copy(),
                             _tree_of(dec.col))}


def map_state_from_numpy(pos, feat, count, cell_data, cell_fill, cell_size,
                         n_dropped, in_pos=None, in_rgb=None, in_count=0,
                         device=None) -> MapState:
    """A JAX map (pos, feat, count and its grid's cell_data, cell_fill,
    cell_size, n_dropped, as numpy) -> the port's MapState on `device`.
    The input cloud defaults to empty buffers of the point capacity.
    device: the card unless the caller asks for the CPU."""
    dev = resolve_device(device)

    def f32(a):  # a copy: the source arrays may be read-only views
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)

    cap = np.asarray(pos).shape[0]
    grid = HashGrid(cell_data=f32(cell_data).contiguous(),
                    cell_size=f32(cell_size).reshape(()),
                    n_dropped=i32(n_dropped).reshape(()),
                    cell_fill=i32(cell_fill))
    return MapState(
        pos=f32(pos), feat=f32(feat), count=i32(count).reshape(()),
        grid=grid,
        in_pos=f32(in_pos) if in_pos is not None
        else torch.zeros((cap, 3), device=dev),
        in_rgb=f32(in_rgb) if in_rgb is not None
        else torch.zeros((cap, 3), device=dev),
        in_count=i32(in_count).reshape(()))


def exposure_state_from_numpy(resume: Dict[str, Any], dim: int, device=None
                              ) -> Tuple[torch.Tensor, Dict[int, np.ndarray],
                                         Dict[int, np.ndarray]]:
    """A checkpoint's `resume` exposure fields (either package's) -> the
    session's (exposure_feat (dim,) on `device`, kf_exposure,
    mapped_exposure), the dicts by frame index as float32 numpy. Missing
    fields give zeros and empty dicts. device: the card unless the caller
    asks for the CPU."""
    dev = resolve_device(device)
    ef = np.asarray(resume.get("exposure_feat", np.zeros(dim)), np.float32)
    if ef.shape != (dim,):
        raise ValueError(f"checkpoint exposure latent of shape {ef.shape}, "
                         f"expected ({dim},) (model.exposure_dim)")

    def frames(d):
        return {int(k): np.asarray(v, np.float32).reshape(dim)
                for k, v in (d or {}).items()}

    return (torch.tensor(ef, device=dev), frames(resume.get("kf_exposure")),
            frames(resume.get("mapped_exposure")))
