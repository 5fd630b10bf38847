"""The benchmark's own count of the model's work and the k-NN's bound.

`sample_macs` counts the multiply-adds one render sample needs in each
trunk from the configuration's widths (`widths` in the configuration's
file): the geometry decoder, the color decoder and, with
`model.encode_rel_pos_in_col`, the neighbour transform over the k
neighbours. `iteration_flops` turns them into the model FLOPs of one
optimizer iteration: the forward pass, the backward pass to every input a
trained leaf depends on (as many multiply-adds again), and the weight
gradients of the trained trunks (once more their forward count). Frozen
trunks (`mapping.fix_geo_decoder`) take no weight gradient, and tracking
trains the pose alone. It never asks the program what it computed.

`knn_query_cost` is a frozen copy of `loopy_slam_torch/ops/knn.query_cost`,
the least the select kernel must move and compute for its inputs;
`tests/test_bench_counts.py` holds it equal to the program's.
"""

from __future__ import annotations

from typing import Dict

import torch

# the H100 SXM's published dense peaks (NVIDIA's data sheet) at 700 W:
# float32 outside the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def sample_macs(widths: Dict, cfg: Dict) -> Dict[str, int]:
    """Forward multiply-adds of one sample: {"geo", "col", "neigh"}."""
    c = cfg["model"]["c_dim"]
    nb, skip = widths["n_blocks"], widths["skip"]

    def trunk(emb: int, hidden: int, out: int) -> int:
        macs, d = 0, emb
        for i in range(nb):
            macs += d * hidden
            d = hidden + (emb if i == skip else 0)
        return macs + nb * c * hidden + hidden * out

    geo = trunk(widths["geo_embed"], widths["geo_hidden"], 1)
    col = trunk(2 * widths["col_embed"], widths["col_hidden"], 3)
    neigh = 0
    if cfg["model"]["encode_rel_pos_in_col"]:
        nin = 2 * widths["rel_embed"] + c
        neigh = cfg["pointcloud"]["nn_num"] * (
            nin * widths["col_hidden"] + widths["col_hidden"] * c)
    return {"geo": geo, "col": col, "neigh": neigh}


def iteration_flops(kind: str, rays: int, widths: Dict, cfg: Dict) -> int:
    """Model FLOPs of one iteration over `rays` rays: kind "track" (the
    pose trains), "geometry" or "color" (a mapping stage)."""
    m = sample_macs(widths, cfg)
    geo_w = 0 if cfg["mapping"]["fix_geo_decoder"] else m["geo"]
    col_w = 0 if cfg["mapping"]["fix_color_decoder"] else m["col"] + m["neigh"]
    if kind == "track":
        macs = 2 * (m["geo"] + m["col"] + m["neigh"])
    elif kind == "geometry":
        macs = 2 * m["geo"] + geo_w
    elif kind == "color":
        macs = 2 * (m["geo"] + m["col"] + m["neigh"]) + geo_w + col_w
    else:
        raise ValueError(f"unknown iteration kind {kind!r}")
    return 2 * macs * rays * cfg["rendering"]["N_surface"]


_P1, _P2, _P3 = 73856093, 19349669, 83492791
_OFFSETS27 = torch.tensor([[dx, dy, dz] for dx in (-1, 0, 1)
                           for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
                          dtype=torch.int32)


def _stencil_rows(cell_data, cell_size, queries):
    """The 27 stencil rows a query scans, a repeated hash redirected to
    the always-empty overflow row."""
    T = cell_data.shape[0] - 1
    cs = torch.as_tensor(cell_size, dtype=torch.float32,
                         device=queries.device)
    base = torch.floor(queries / cs).to(torch.int32)
    ijk = base[:, None, :] + _OFFSETS27.to(queries.device)[None]
    h = ((ijk[..., 0] * _P1) ^ (ijk[..., 1] * _P2)
         ^ (ijk[..., 2] * _P3)) & (T - 1)
    eq = h[:, :, None] == h[:, None, :]
    dup = torch.tril(eq, diagonal=-1).any(dim=-1)
    return torch.where(dup, T, h).long()


def knn_query_cost(cell_data, cell_size, cell_fill, queries, k: int,
                   per_query_radius: bool = False):
    """(bytes, flops) the select kernel needs for these queries: the fill
    count and the filled slots of each row the queries touch, read once,
    the queries, their radii and cell_size read, D/I/neighbor_num
    written; 8 f32 operations per filled candidate in each stencil."""
    h = _stencil_rows(cell_data, cell_size, queries)
    fill = cell_fill.long()
    rows = torch.unique(h)
    Q = queries.shape[0]
    nbytes = (int(fill[rows].sum()) * 16 + rows.numel() * 4
              + Q * (16 if per_query_radius else 12) + 4 + Q * (k * 8 + 4))
    return nbytes, int(fill[h].sum()) * 8


def knn_bound_s(nbytes: int, flops: int) -> float:
    """The least time the card could take: bytes over the HBM peak or
    operations over the f32 peak, whichever is larger."""
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_F32_FLOPS)
