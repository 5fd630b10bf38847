"""Analytic per-iteration collective traffic of the two multi-device
flavours (the port's copy of loopy_slam_tpu/parallel/cost_model.py).

- ray-DP (parallel/sharded.py): the map is replicated and rays are data
  parallel; every optimizer iteration sums the gradients of the whole
  trainable set (decoders and the whole feature buffer). A ring
  all-reduce moves 2 (n - 1) / n of the payload per rank.
- map-shard (parallel/map_shard.py): the point buffer is cell-sharded;
  every sample decode runs a ring k-NN (n hops of the query block and its
  running top-k) and a ring feature fetch (n hops of [feat || pos] rows,
  and again for the gradient's way back). Traffic scales with the sample
  count, not the map size.

All sizes are bytes per rank per executed collective, float32 on the wire.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Dict

import numpy as np

F32 = 4

Spec = namedtuple("Spec", "shape dtype")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _itemsize(dtype) -> int:
    if hasattr(dtype, "itemsize") and not isinstance(dtype, type):
        return int(dtype.itemsize)
    return np.dtype(dtype).itemsize


def tree_bytes(tree) -> int:
    """Payload bytes of a nest of dicts, lists and tuples whose leaves have
    .shape and .dtype (torch tensors, numpy arrays or Specs)."""
    total = 0
    for leaf in _leaves(tree):
        size = int(np.prod(tuple(getattr(leaf, "shape", ()))) or 1)
        total += size * _itemsize(getattr(leaf, "dtype", np.float32))
    return total


def allreduce_bytes_per_chip(payload_bytes: int, n_devices: int) -> float:
    """Ring all-reduce traffic per rank: reduce-scatter + all-gather, each
    moving (n - 1) / n of the payload."""
    if n_devices <= 1:
        return 0.0
    return 2.0 * (n_devices - 1) / n_devices * payload_bytes


def dp_iter_bytes_per_chip(trainable, n_devices: int) -> float:
    """ray-DP: one iteration sums the gradients of the whole trainable set
    plus the three loss terms."""
    return allreduce_bytes_per_chip(tree_bytes(trainable) + 3 * F32,
                                    n_devices)


def ring_knn_bytes_per_chip(q_local: int, k: int, n_devices: int) -> float:
    """map-shard ring k-NN: n hops of the rotating state, queries (Q, 3)
    + radii (Q,) + best D/I/owner (Q, k) each."""
    per_hop = q_local * (4 * F32 + 3 * k * F32)
    return n_devices * per_hop


def ring_fetch_bytes_per_chip(q_local: int, k: int, feat_dim: int,
                              n_devices: int,
                              with_backward: bool = True) -> float:
    """map-shard ring fetch: n hops of (I, owner, acc (Q, k, F)) with
    F = feat_dim + 3; the backward reverses the ring with a same-shaped
    cotangent."""
    F = feat_dim + 3
    per_hop = q_local * k * (2 * F32 + F * F32)
    fwd = n_devices * per_hop
    return fwd * (2 if with_backward else 1)


def mshard_iter_bytes_per_chip(q_local: int, k: int, feat_dim: int,
                               dec_bytes: int, n_devices: int,
                               knn_every: int = 1) -> float:
    """map-shard: one iteration = ring k-NN (amortized over knn_every) +
    ring fetch forward and backward + the sum of the replicated (decoder)
    gradients; the feature gradients stay on their shard."""
    return (ring_knn_bytes_per_chip(q_local, k, n_devices) / max(knn_every, 1)
            + ring_fetch_bytes_per_chip(q_local, k, feat_dim, n_devices)
            + allreduce_bytes_per_chip(dec_bytes, n_devices))


def bench_budget(n_devices: int = 8) -> Dict[str, float]:
    """Per-mapping-iteration MB per rank at the bench shapes (synthetic
    room: 5000 rays x 8 samples an iteration, k = 8, c_dim 32 -> 64 feature
    lanes, capacity 2^15, decoders ~0.4 MB) and at the flagship capacity
    2^17."""
    k, c2 = 8, 64
    dec_bytes = 400_000
    out = {}
    for name, cap in (("bench", 2 ** 15), ("flagship", 2 ** 17)):
        samples = 5000 * 8
        q_local = samples // n_devices
        trainable = {"feat": Spec((cap, c2), np.float32),
                     "dec": Spec((dec_bytes // F32,), np.float32)}
        out[f"dp_iter_MB_{name}"] = dp_iter_bytes_per_chip(
            trainable, n_devices) / 1e6
        out[f"mshard_iter_MB_{name}"] = mshard_iter_bytes_per_chip(
            q_local, k, c2, dec_bytes, n_devices) / 1e6
    return out
