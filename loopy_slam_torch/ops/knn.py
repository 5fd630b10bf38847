"""Spatial-hash radius k-NN over a fixed-capacity point buffer.

Port of loopy_slam_tpu/ops/knn.py. Points are hashed into a grid of cell
edge >= the largest query radius; a query inspects the 3x3x3 block of cells
around its own and takes the k nearest candidates. `cell_data[h]` holds
cell h's up-to-M candidates packed as (x, y, z, bitcast(index | _IDX_TAG))
exactly as the JAX package lays them out, so `build`/`insert` are
bit-comparable with it and a JAX HashGrid converts directly (convert.py).

`query` is the hot call. On CUDA tensors it launches the hand-written
kernel in csrc/knn_select.cu, which does all of query's work (hashing the
stencil, redirecting duplicate probes, reading rows straight from
cell_data, the packed-key top-k, the final D/I/neighbor_num mapping). On
CPU tensors it runs `_query_plain`, the plain PyTorch version of the same
function, bit-equal to the JAX query.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils import cost, telemetry

# Large primes for 3-D spatial hashing (Teschner et al. 2003).
_P1, _P2, _P3 = 73856093, 19349669, 83492791

# 3x3x3 neighbor-cell offsets, in the order the stencil probes them.
_OFFSETS27 = np.array(
    [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
     for dz in (-1, 0, 1)],
    dtype=np.int32,
)
_S = _OFFSETS27.shape[0]

_FAR = 1e9
_IDX_TAG = 1 << 30  # exponent tag the JAX layout keeps on packed indices

# supported k: the kernel keeps its K best keys in registers (K = 8 or 16)
_MAX_K = 16


class HashGrid(NamedTuple):
    """Spatial-hash index: one packed candidate row per cell.

    cell_data: (table_size + 1, M, 4) float32, per candidate (x, y, z,
      bitcast int32 index | _IDX_TAG); empty slots (1e9, 1e9, 1e9, tag).
      Row table_size is the always-empty overflow row.
    cell_size: () float32 tensor, cell edge >= the max query radius.
    n_dropped: () int32 tensor, points not indexed (row overflow).
    cell_fill: (table_size + 1,) int32 occupied slots per row.
    """

    cell_data: torch.Tensor
    cell_size: torch.Tensor
    n_dropped: torch.Tensor
    cell_fill: torch.Tensor


class _Launches:
    """Launch count of the CUDA kernel: the wrapper adds one per launch."""

    def __init__(self):
        self.count = 0

    def reset(self):
        self.count = 0


KNN_SELECT_LAUNCHES = _Launches()


def _hash_cells(ijk: torch.Tensor, table_size: int) -> torch.Tensor:
    """int32 cell coords (..., 3) -> hash in [0, table_size). Relies on
    int32 multiply wrap-around, like the reference; table_size must be a
    power of two."""
    h = (ijk[..., 0] * _P1) ^ (ijk[..., 1] * _P2) ^ (ijk[..., 2] * _P3)
    return h & (table_size - 1)


def _cell_of(points: torch.Tensor, cell_size) -> torch.Tensor:
    """floor (not truncation: negative coordinates) of points / cell, in f32."""
    cs = torch.as_tensor(cell_size, dtype=torch.float32, device=points.device)
    return torch.floor(points / cs).to(torch.int32)


def _empty_row(device) -> torch.Tensor:
    tag = torch.tensor([_IDX_TAG], dtype=torch.int32).view(torch.float32)
    return torch.cat([torch.full((3,), _FAR), tag]).to(device)


def build(points: torch.Tensor, valid: torch.Tensor, cell_size,
          table_size: int, max_per_cell: int = 16) -> HashGrid:
    """Build (or rebuild) the index: stable sort by cell hash + scatter."""
    dev = points.device
    cap = points.shape[0]
    T, M = int(table_size), int(max_per_cell)
    cs = torch.as_tensor(cell_size, dtype=torch.float32, device=dev)
    codes = _hash_cells(_cell_of(points, cs), T)
    codes = torch.where(valid, codes, T)
    order = torch.argsort(codes, stable=True)
    codes_sorted = codes[order]
    counts = torch.bincount(codes.long(), minlength=T + 1).to(torch.int32)
    starts = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(counts, 0)[:-1].to(torch.int32)])
    rank = torch.arange(cap, dtype=torch.int32, device=dev) \
        - starts[codes_sorted.long()]
    in_table = codes_sorted < T
    ok = in_table & (rank < M)
    n_dropped = torch.sum(in_table & ~ok).to(torch.int32)
    row = torch.where(ok, codes_sorted, T).long()
    col = torch.where(ok, rank, 0).long()
    idx_bits = (order.to(torch.int32) | _IDX_TAG).view(torch.float32)
    packed = torch.cat([points[order], idx_bits[:, None]], dim=-1)
    empty = _empty_row(dev)
    cell_data = empty.expand(T + 1, M, 4).clone()
    # overflowed / invalid points all land in the overflow row, which is
    # reset afterwards; real (row, col) pairs are unique
    cell_data[row, col] = packed
    cell_data[T] = empty
    fill = torch.clamp(counts, max=M)
    fill[T] = 0
    return HashGrid(cell_data=cell_data, cell_size=cs, n_dropped=n_dropped,
                    cell_fill=fill)


def build_adaptive(points: torch.Tensor, valid: torch.Tensor, cell_size,
                   table_size: int, max_per_cell: int = 16,
                   max_doublings: int = 3,
                   table_doublings: int = 3) -> HashGrid:
    """build(), escalating capacity until nothing drops: double
    max_per_cell up to max_doublings times, then double table_size and
    restart the row-depth ladder, up to table_doublings times. Reads
    n_dropped on the host; for rebuilds off the per-frame path only."""
    T = table_size
    for _ in range(table_doublings + 1):
        M = max_per_cell
        grid = build(points, valid, cell_size, T, M)
        for _ in range(max_doublings):
            if int(grid.n_dropped) == 0:
                break
            M *= 2
            grid = build(points, valid, cell_size, T, M)
        if int(grid.n_dropped) == 0:
            break
        T *= 2
    return grid


def insert(grid: HashGrid, new_points: torch.Tensor, new_idx: torch.Tensor,
           new_valid: torch.Tensor) -> HashGrid:
    """Incrementally add a batch of points to an existing index. Same
    candidate set as a rebuild; slot order within a row may differ. The
    table size and row depth come from the grid's own shape."""
    M = grid.cell_data.shape[1]
    T = grid.cell_data.shape[0] - 1
    dev = new_points.device
    A = new_points.shape[0]
    codes = _hash_cells(_cell_of(new_points, grid.cell_size), T)
    codes = torch.where(new_valid, codes, T)
    order = torch.argsort(codes, stable=True)
    cs = codes[order].contiguous()
    first = torch.searchsorted(cs, cs, side="left").to(torch.int32)
    rank = torch.arange(A, dtype=torch.int32, device=dev) - first
    col = grid.cell_fill[cs.long()] + rank
    in_table = cs < T
    ok = in_table & (col < M)
    n_drop = torch.sum(in_table & ~ok).to(torch.int32)
    row = torch.where(ok, cs, T).long()
    col = torch.where(ok, col, 0).long()
    idx_bits = (new_idx[order].to(torch.int32) | _IDX_TAG).view(torch.float32)
    packed = torch.cat([new_points[order], idx_bits[:, None]], dim=-1)
    cell_data = grid.cell_data.clone()
    cell_data[row, col] = packed
    cell_data[T] = _empty_row(dev)
    delta = torch.zeros(T + 1, dtype=torch.int32, device=dev).index_add_(
        0, codes.long(), new_valid.to(torch.int32))
    fill = torch.clamp(grid.cell_fill + delta, max=M)
    fill[T] = 0
    return HashGrid(cell_data=cell_data, cell_size=grid.cell_size,
                    n_dropped=grid.n_dropped + n_drop, cell_fill=fill)


def _id_bits(M: int) -> int:
    """Low mantissa bits of the packed key that hold the candidate id: they
    cover 27*M ids plus the all-ones exhausted marker (>= 11, <= 16)."""
    bits = max(11, (_S * M + 1).bit_length())
    if bits > 16:
        raise ValueError(f"candidate row too wide even for 16-bit ids "
                         f"(max_per_cell {M}); shrink the cells instead")
    return bits


def stencil_rows(grid: HashGrid, queries: torch.Tensor) -> torch.Tensor:
    """(Q, 27) int64 rows of cell_data a query scans: the 27 stencil
    hashes, with a probe whose hash an EARLIER probe already had redirected
    to the always-empty overflow row (so no row is scanned twice)."""
    T = grid.cell_data.shape[0] - 1
    base = _cell_of(queries, grid.cell_size)
    off = torch.as_tensor(_OFFSETS27, device=queries.device)
    h = _hash_cells(base[:, None, :] + off[None, :, :], T)  # (Q, S)
    eq = h[:, :, None] == h[:, None, :]
    dup = torch.tril(eq, diagonal=-1).any(dim=-1)
    return torch.where(dup, T, h).long()


def _query_plain(grid: HashGrid, queries: torch.Tensor, k: int, radius):
    """The plain PyTorch version of the kernel: the same packed-key
    selection on the gathered (Q, 27*M) candidate rows, bit-equal to the
    JAX query. Materializes the rows, so its memory is Q*27*M*16 bytes."""
    M = grid.cell_data.shape[1]
    T = grid.cell_data.shape[0] - 1
    Q = queries.shape[0]
    id_mask = (1 << _id_bits(M)) - 1
    h = stencil_rows(grid, queries)
    rows = grid.cell_data.reshape(T + 1, M * 4)[h.reshape(-1)].reshape(
        Q, _S * M, 4)
    dx = rows[..., 0] - queries[:, None, 0]
    dy = rows[..., 1] - queries[:, None, 1]
    dz = rows[..., 2] - queries[:, None, 2]
    d2 = (dx * dx + dy * dy) + dz * dz  # the kernel's summation order
    gid = torch.arange(_S * M, dtype=torch.int32, device=queries.device)
    key = (d2.view(torch.int32) & ~id_mask) | gid
    top, pos = torch.topk(key, k, dim=1, largest=False, sorted=True)
    D = (top | id_mask).view(torch.float32)
    idx_bits = torch.gather(rows[..., 3].view(torch.int32), 1, pos)
    I = idx_bits & (_IDX_TAG - 1)
    valid_hit = D < 1e10
    I = torch.where(valid_hit, I, 0)
    D = torch.where(valid_hit, D, torch.full((), 1e10, device=D.device))
    r = torch.as_tensor(radius, dtype=torch.float32, device=queries.device)
    r2 = (r * r)[:, None] if r.dim() == 1 else r * r
    neighbor_num = torch.sum(D < r2, dim=-1).to(torch.int32)
    return D, I, neighbor_num


def _query_cuda(grid: HashGrid, queries: torch.Tensor, k: int, radius):
    """Launch csrc/knn_select.cu. Validates everything the kernel assumes
    and raises on anything else; never falls back to the plain version."""
    from ..csrc.build import load_library

    cd = grid.cell_data
    dev = queries.device
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"knn_select supports 1 <= k <= {_MAX_K}, got {k}")
    if cd.device != dev or grid.cell_size.device != dev:
        raise ValueError("grid and queries must be on the same device")
    if cd.dtype != torch.float32 or queries.dtype != torch.float32 \
            or grid.cell_size.dtype != torch.float32:
        raise TypeError("knn_select takes float32 cell_data/queries/cell_size")
    if cd.dim() != 3 or cd.shape[2] != 4 or not cd.is_contiguous() \
            or cd.data_ptr() % 16:
        raise ValueError(f"cell_data must be contiguous, 16-byte aligned "
                         f"(T+1, M, 4), got {tuple(cd.shape)}")
    T, M = cd.shape[0] - 1, cd.shape[1]
    if T <= 0 or T & (T - 1):
        raise ValueError(f"table size {T} is not a power of two")
    if queries.dim() != 2 or queries.shape[1] != 3:
        raise ValueError(f"queries must be (Q, 3), got {tuple(queries.shape)}")
    if grid.cell_size.numel() != 1:
        raise ValueError("cell_size must be a scalar tensor")
    fill = grid.cell_fill
    if fill.device != dev or fill.dtype != torch.int32 \
            or fill.shape != (T + 1,) or not fill.is_contiguous():
        raise ValueError(f"cell_fill must be a contiguous int32 (T+1,) = "
                         f"({T + 1},) tensor on {dev}, got {fill.dtype} "
                         f"{tuple(fill.shape)} on {fill.device}")
    id_bits = _id_bits(M)
    queries = queries.contiguous()
    Q = queries.shape[0]
    r_ptr, r_scalar, r_keep = None, 0.0, None
    if isinstance(radius, torch.Tensor):
        r = radius.to(device=dev, dtype=torch.float32)
        if r.dim() == 0:
            r = r.expand(Q)
        if r.shape != (Q,):
            raise ValueError(f"radius must be a scalar or (Q,), got "
                             f"{tuple(radius.shape)}")
        r_keep = r.contiguous()
        r_ptr = r_keep.data_ptr()
    else:
        r_scalar = float(radius)
    D = torch.empty((Q, k), dtype=torch.float32, device=dev)
    I = torch.empty((Q, k), dtype=torch.int32, device=dev)
    nn = torch.empty((Q,), dtype=torch.int32, device=dev)
    if Q == 0:
        return D, I, nn
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.knn_select_launch(
            cd.data_ptr(), fill.data_ptr(), queries.data_ptr(), r_ptr,
            ctypes.c_float(r_scalar), grid.cell_size.data_ptr(), D.data_ptr(),
            I.data_ptr(), nn.data_ptr(), Q, T, M, id_bits, k, stream)
    if rc != 0:
        raise RuntimeError(f"knn_select launch failed with CUDA error {rc} "
                           f"(Q={Q}, T={T}, M={M}, k={k})")
    KNN_SELECT_LAUNCHES.count += 1
    del r_keep
    return D, I, nn


def query_cost(grid: HashGrid, queries: torch.Tensor, k: int,
               per_query_radius: bool = False):
    """The work of query() on these inputs, as (bytes, flops): the least
    the function must move and compute. Bytes: the fill count and the
    filled slots of each row the queries touch, read once (empty slots
    hold the 1e9 sentinel and change no output), the queries, their radii
    (per_query_radius) and cell_size read, D/I/neighbor_num written.
    Flops: 8 f32 operations per filled candidate in each query's stencil
    (3 sub, 3 mul, 2 add). Reads the fill counts on the host (a sync on
    the card)."""
    h = stencil_rows(grid, queries)  # repeated probes -> empty row
    fill = grid.cell_fill.long()
    rows = torch.unique(h)
    Q = queries.shape[0]
    nbytes = (int(fill[rows].sum()) * 16 + rows.numel() * 4
              + Q * (16 if per_query_radius else 12) + 4 + Q * (k * 8 + 4))
    return nbytes, int(fill[h].sum()) * 8


def _report_cost(grid: HashGrid, queries: torch.Tensor, k: int, radius):
    """query_cost to every active cost counter (utils/cost.py), which
    cannot see the kernel: it is launched through ctypes."""
    if cost.active():
        per_query = isinstance(radius, torch.Tensor) and radius.dim() == 1
        with cost.uncounted():
            nbytes, flops = query_cost(grid, queries, k, per_query)
        cost.report("knn_select", flops, nbytes)


def _select(grid: HashGrid, queries: torch.Tensor, k: int, radius):
    if queries.device.type == "cpu":
        return _query_plain(grid, queries, k, radius)
    return _query_cuda(grid, queries, k, radius)


def query(grid: HashGrid, points: torch.Tensor, queries: torch.Tensor,
          k: int, radius, return_pos: bool = False):
    """k nearest neighbors of each query within the 3x3x3 cell stencil.

    Exact within `radius` provided radius <= grid.cell_size. radius is a
    scalar or (Q,). Returns D (Q, k) squared distances ascending, with the
    id bits set (an upper bound on the exact distance, so D < r^2 never
    over-counts), 1e10 where empty; I (Q, k) int32 buffer indices (0 where
    empty); neighbor_num (Q,) int32 count of D < r^2; and, with
    return_pos, the neighbor positions points[I] (1e9 where empty).
    The table size and row depth come from the grid's own shape. Under a
    cost counter the call counts as query_cost, on either route.
    """
    _report_cost(grid, queries, k, radius)
    with cost.uncounted():
        D, I, nn = _select(grid, queries, k, radius)
    if return_pos:
        pos = points[I.reshape(-1).long()].reshape(queries.shape[0], k, 3)
        pos = torch.where((D < 1e10)[..., None], pos,
                          torch.full((), _FAR, device=pos.device))
        return D, I, nn, pos
    return D, I, nn


def query_chunked(grid: HashGrid, points, queries, k: int, radius,
                  chunk: int = 16384):
    """query() with the same result (and cost). On the card the kernel has
    no temporary, so it runs as one launch; on the CPU the plain version's
    (chunk, 27*M, 4) gather bounds its memory."""
    Q = queries.shape[0]
    with telemetry.current().span("knn.query", q=Q):
        if queries.device.type != "cpu" or Q <= chunk:
            return query(grid, points, queries, k, radius)
        _report_cost(grid, queries, k, radius)
        with cost.uncounted():
            r = torch.as_tensor(radius, dtype=torch.float32,
                                device=queries.device)
            r = r.expand(Q) if r.dim() == 0 else r
            outs = [_select(grid, queries[s:s + chunk], k, r[s:s + chunk])
                    for s in range(0, Q, chunk)]
            return tuple(torch.cat(parts) for parts in zip(*outs))


def brute_force_knn(points, valid, queries, k):
    """Reference oracle: exact k-NN by full pairwise distances (test use)."""
    d2 = torch.sum((queries[:, None, :] - points[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(valid[None, :], d2, torch.full((), 1e10))
    neg_top, idx = torch.topk(-d2, k, dim=1)
    return -neg_top, idx
