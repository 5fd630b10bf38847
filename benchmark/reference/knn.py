"""The plain reference of the radius k-NN: brute force over every point of
the map, in float64 (or, for the control, in bfloat16 coordinates).
Plain PyTorch; it imports nothing of the program."""

from __future__ import annotations

import torch


def nearest(points, queries, k: int, r2, dt=torch.float64,
            block: int = 256):
    """Per query, the ids (Q, k) of its k nearest points within squared
    radius r2 (a scalar or (Q,)), nearest first, -1 where fewer lie
    inside. Distances are computed in `dt` from coordinates in `dt`."""
    P = points.to(dt)
    Q = queries.shape[0]
    r2 = torch.as_tensor(r2, dtype=torch.float64, device=queries.device)
    r2 = r2.expand(Q) if r2.dim() == 0 else r2
    out = torch.full((Q, k), -1, dtype=torch.int64, device=queries.device)
    kk = min(k, P.shape[0])
    for s in range(0, Q, block):
        q = queries[s:s + block].to(dt)
        d = ((q[:, None, :] - P[None, :, :]) ** 2).sum(-1).to(torch.float64)
        top, idx = torch.topk(d, kk, dim=1, largest=False, sorted=True)
        inside = top < r2[s:s + block, None]
        out[s:s + block, :kk] = torch.where(inside, idx,
                                            torch.full_like(idx, -1))
    return out


def exact_sq_dist(points, queries, ids):
    """Squared distances (Q, k) in float64 from each query to the points
    `ids` (Q, k), +inf where an id is -1."""
    p = points.to(torch.float64)[ids.clamp(min=0)]
    d = ((p - queries.to(torch.float64)[:, None, :]) ** 2).sum(-1)
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


def set_gap(points, queries, ids_a, ids_b, r2):
    """How far apart two neighbour sets lie, per query: the sorted exact
    squared distances of each set, a missing neighbour taken at the
    radius, compared slot by slot, the largest gap as a share of r2."""
    r2 = torch.as_tensor(r2, dtype=torch.float64, device=queries.device)
    r2 = r2.expand(queries.shape[0]) if r2.dim() == 0 else r2
    a = torch.minimum(exact_sq_dist(points, queries, ids_a), r2[:, None])
    b = torch.minimum(exact_sq_dist(points, queries, ids_b), r2[:, None])
    a, b = torch.sort(a, dim=1).values, torch.sort(b, dim=1).values
    return (torch.abs(a - b) / r2[:, None]).amax(dim=1)
