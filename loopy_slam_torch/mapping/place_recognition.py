"""ORB-based place recognition for submap loop-closure proposals.

Port of loopy_slam_tpu/mapping/place_recognition.py. ORB descriptors come
from the port's own ops/orb.py; segment anchors are scored by exact
cross-checked mutual-nearest-neighbour Hamming matching, computed on the
session's device (xor of the (Na, Nb, 32) byte pairs and a popcount
table). Past `shortlist` stored anchors, a multi-index vote narrows the
candidates first: each descriptor is split into 16 uint16 keys, and a
query descriptor gives one vote to every anchor with a stored descriptor
sharing at least one key at the same position (the JAX package runs the
same vote in C++, native/matcher.cpp's HamIndex). Rankings are made on the
host with the JAX package's numpy calls, so ties break the same way.

API:
  db.add(features)                -> register a segment anchor
  db.query(features, k)           -> top-k (id, score) over registered
  baseline_score(anchor, frames)  -> min similarity of a segment's anchor
                                     to its own frames
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device

_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int32)


def _dev_des(des, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(des, np.uint8),
                           device=device)


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na, Nb) int32 Hamming distances of packed (N, 32) uint8
    descriptors."""
    x = torch.bitwise_xor(a[:, None, :], b[None, :, :]).long()
    return _POPCOUNT.to(a.device)[x].sum(-1, dtype=torch.int32)


def match_score(des_a, des_b, max_dist: int = 64,
                device=None) -> float:
    """Similarity in [0, 1]: the fraction of cross-checked mutual nearest
    neighbours (first index on ties) with Hamming distance < max_dist.
    Numpy descriptors go to `device` (the card unless the caller asks for
    the CPU); tensors are matched where des_a lies."""
    if des_a is None or des_b is None or len(des_a) == 0 or len(des_b) == 0:
        return 0.0
    a = des_a if isinstance(des_a, torch.Tensor) else _dev_des(
        des_a, resolve_device(device))
    b = des_b if isinstance(des_b, torch.Tensor) else _dev_des(
        des_b, a.device)
    d = hamming(a, b.to(a.device))
    nn_ab = d.argmin(1)
    nn_ba = d.argmin(0)
    ia = torch.arange(a.shape[0], device=a.device)
    good = (nn_ba[nn_ab] == ia) & (d[ia, nn_ab] < max_dist)
    return float(int(good.sum())) / max(min(a.shape[0], b.shape[0]), 1)


def _keys(des: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 -> (N, 16) int32 little-endian uint16 substrings."""
    d = des.to(torch.int32)
    return d[:, 0::2] | (d[:, 1::2] << 8)


class QueryResult(NamedTuple):
    Id: int
    Score: float


class ScoreDB:
    """add/query over segment anchors (the reference's DBoW3 Database
    semantics). Past `shortlist` anchors, the multi-index vote picks the
    candidates that the exact matcher scores."""

    def __init__(self, max_dist: int = 64, shortlist: int = 24,
                 device=None):
        self.entries: List[Optional[np.ndarray]] = []
        self._dev: List[Optional[torch.Tensor]] = []
        self.max_dist = max_dist
        self.shortlist = shortlist
        self.device = resolve_device(device)
        self._keys: List[torch.Tensor] = []     # per stored anchor (n, 16)
        self._anchor: List[int] = []

    def add(self, des: Optional[np.ndarray]):
        t = None
        if des is not None and len(des):
            t = _dev_des(des, self.device)
            self._keys.append(_keys(t))
            self._anchor.append(len(self.entries))
        self.entries.append(des)
        self._dev.append(t)

    def query_votes(self, des, n_anchors: int) -> np.ndarray:
        """(n_anchors,) float32: per anchor, the number of query
        descriptors sharing at least one 16-bit key (same position) with
        one of the anchor's descriptors."""
        votes = np.zeros(n_anchors, np.float32)
        if des is None or len(des) == 0 or n_anchors == 0:
            return votes
        q = _keys(_dev_des(des, self.device))
        hit = torch.zeros((q.shape[0], n_anchors), dtype=torch.bool,
                          device=self.device)
        for keys, an in zip(self._keys, self._anchor):
            if an < n_anchors:
                hit[:, an] = (q[:, None, :] == keys[None, :, :]).any(
                    -1).any(-1)
        votes[:] = hit.sum(0).cpu().numpy()
        return votes

    def query(self, des: Optional[np.ndarray], k: int) -> List[QueryResult]:
        n = len(self.entries)
        shortlist = max(self.shortlist, 2 * k)
        q = None if des is None or len(des) == 0 else _dev_des(
            des, self.device)
        score = lambda i: match_score(q, self._dev[i], self.max_dist)  # noqa
        if n > shortlist and des is not None:
            votes = self.query_votes(des, n)
            cand = np.argsort(votes)[::-1][:shortlist]
            cand = [int(i) for i in cand if votes[i] > 0]
            scores = np.zeros(n, np.float32)
            for i in cand:
                scores[i] = score(i)
        else:
            scores = np.array([score(i) for i in range(n)], np.float32)
        order = np.argsort(scores)[::-1][:k]
        return [QueryResult(int(i), float(scores[i])) for i in order]


def baseline_score(anchor_des, frame_des_list, max_dist: int = 64,
                   device=None) -> float:
    """Adaptive per-segment threshold: the MIN similarity of the segment
    anchor to the segment's own frames; -1 if there are none."""
    scores = [match_score(anchor_des, d, max_dist, device)
              for d in frame_des_list]
    return float(min(scores)) if scores else -1.0
