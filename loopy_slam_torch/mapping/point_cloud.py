"""Neural point cloud: fixed-capacity buffers with masked insertion.

Port of loopy_slam_tpu/mapping/point_cloud.py. The map is a set of
fixed-capacity device tensors plus the spatial-hash index (ops/knn.py).
Insertion gates candidate surface points on having no neighbour within
the add radius (radius_add, radius_min for color-gradient picks, or the
per-pixel dynamic radius) and on every spawned point's hash row having a
free slot; each surviving location spawns N_add points stratified along
its ray with N(0, 0.1) features. The sensor-space input cloud (final PLY export) is
accumulated in a parallel buffer. Counts stay on the device, so an
insertion never waits for the host.

sample_near_pcl_z_vals(_raw) place a zero-depth ray's samples where the
cloud lies (rendering.sample_near_pcl): one k-NN over 25 probe depths a
ray, of which only the in-radius counts are read.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import resolve_device
from ..ops import knn


def effective_cell_and_slots(cfg):
    """The one place the hash-grid cell edge and slot capacity derive from
    the config (MapOptions and RenderOptions both call this)."""
    pc = cfg["pointcloud"]
    if cfg["use_dynamic_radius"]:
        cell = float(pc["radius_query_ratio"] * pc["radius_add_max"])
        mpc = max(int(pc["max_per_cell"]), 64)
    else:
        cell = float(pc["radius_query"])
        mpc = int(pc["max_per_cell"])
    return cell, mpc


class MapOptions(NamedTuple):
    """Static point-cloud configuration (from YAML pointcloud.*)."""

    capacity: int = 2 ** 19
    input_capacity: int = 2 ** 19
    c_dim: int = 32
    nn_num: int = 8
    N_add: int = 3
    radius_add: float = 0.04
    radius_min: float = 0.02
    radius_query: float = 0.08
    near_end_surface: float = 0.98
    far_end_surface: float = 1.02
    fix_interval_when_add_along_ray: bool = False
    cell_size: float = 0.08
    table_size: int = 2 ** 17
    max_per_cell: int = 16

    @staticmethod
    def from_cfg(cfg):
        pc = cfg["pointcloud"]
        cell, mpc = effective_cell_and_slots(cfg)
        return MapOptions(
            capacity=int(pc["capacity"]),
            input_capacity=int(pc.get("input_capacity", pc["capacity"])),
            c_dim=int(cfg["model"]["c_dim"]),
            nn_num=int(pc["nn_num"]),
            N_add=int(pc["N_add"]),
            radius_add=float(pc["radius_add"]),
            radius_min=float(pc["radius_min"]),
            radius_query=float(pc["radius_query"]),
            near_end_surface=float(pc["near_end_surface"]),
            far_end_surface=float(pc["far_end_surface"]),
            fix_interval_when_add_along_ray=bool(
                pc["fix_interval_when_add_along_ray"]),
            cell_size=cell,
            table_size=int(pc["cell_table_size"]),
            max_per_cell=mpc,
        )


class MapState(NamedTuple):
    """All mutable map tensors."""

    pos: torch.Tensor        # (cap, 3) neural point positions
    feat: torch.Tensor       # (cap, 2*c_dim) packed [geometry || color]
    count: torch.Tensor      # () int32 valid prefix length
    grid: knn.HashGrid       # spatial-hash index over pos[:count]
    in_pos: torch.Tensor     # (in_cap, 3) sensor-space input cloud
    in_rgb: torch.Tensor     # (in_cap, 3) input cloud colors in [0,1]
    in_count: torch.Tensor   # () int32


def init_map(opts: MapOptions, capacity: int = None,
             device=None) -> MapState:
    """Empty map on `device` (the card unless the caller asks for the
    CPU); capacity overrides opts.capacity for the first allocation (the
    orchestrator starts small and doubles as it fills)."""
    dev = resolve_device(device)
    cap, c = capacity or opts.capacity, opts.c_dim
    pos = torch.zeros((cap, 3), device=dev)
    valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
    return MapState(
        pos=pos,
        feat=torch.zeros((cap, 2 * c), device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
        grid=knn.build(pos, valid, opts.cell_size, opts.table_size,
                       opts.max_per_cell),
        in_pos=torch.zeros((opts.input_capacity, 3), device=dev),
        in_rgb=torch.zeros((opts.input_capacity, 3), device=dev),
        in_count=torch.zeros((), dtype=torch.int32, device=dev),
    )


def valid_mask(state: MapState) -> torch.Tensor:
    return torch.arange(state.pos.shape[0], device=state.pos.device) \
        < state.count


def scatter_drop(buf: torch.Tensor, idx: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """buf[idx] = values where idx < len(buf); rows with idx >= len(buf)
    are dropped (jax's mode="drop", which torch indexing would raise on).
    Returns a new tensor; valid idx must be unique."""
    n = buf.shape[0]
    ext = torch.cat([buf, buf.new_zeros((1,) + buf.shape[1:])])
    ext.index_copy_(0, torch.clamp(idx.reshape(-1).long(), max=n), values)
    return ext[:n]


def add_points(state: MapState, opts: MapOptions, draw,
               rays_o, rays_d, gt_depth, gt_color, cand_valid,
               dynamic_r_add=None, is_pts_grad: bool = False
               ) -> Tuple[MapState, torch.Tensor]:
    """Masked point insertion. Returns (new_state, n_locations) with
    n_locations a device scalar. The gate radius is radius_add, or
    radius_min for color-gradient picks (is_pts_grad); a per-candidate
    (A,) dynamic_r_add overrides both. Draws: the new features' standard
    normals (A*N_add, 2c)."""
    dev = rays_o.device
    A = rays_o.shape[0]
    N = opts.N_add
    cap = state.pos.shape[0]
    cand_valid = cand_valid & (gt_depth > 0)
    pts_gt = rays_o + rays_d * gt_depth[:, None]

    r_add = opts.radius_min if is_pts_grad else opts.radius_add
    if dynamic_r_add is not None:
        r_add = dynamic_r_add
    _, _, nn_count = knn.query(state.grid, state.pos, pts_gt, opts.nn_num,
                               r_add)
    gate0 = cand_valid & (nn_count == 0)
    M = state.grid.cell_data.shape[1]

    # stratified points along the ray around the depth reading
    if opts.fix_interval_when_add_along_ray:
        z = gt_depth[:, None] + torch.linspace(-0.04, 0.04, N, device=dev)
    else:
        t = torch.linspace(0.0, 1.0, N, device=dev)
        d = gt_depth[:, None]
        z = opts.near_end_surface * d * (1.0 - t) \
            + opts.far_end_surface * d * t
    new_pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]

    # Row-capacity gate over every spawned point's cell: a location is
    # accepted only if all N_add points find a free slot in their (possibly
    # neighbouring) hash rows; same-batch contenders count each other via a
    # per-row rank over all gate0 candidates' points. The table size is the
    # grid's own (build_adaptive may have grown it).
    AN = A * N
    T = state.grid.cell_data.shape[0] - 1
    cell_h3 = knn._hash_cells(
        knn._cell_of(new_pts.reshape(AN, 3), state.grid.cell_size), T)
    key_h = torch.where(torch.repeat_interleave(gate0, N), cell_h3, T)
    h_order = torch.argsort(key_h, stable=True)
    cs = key_h[h_order].contiguous()
    first = torch.searchsorted(cs, cs, side="left")
    rank_sorted = torch.arange(AN, device=dev) - first
    cell_rank = torch.zeros(AN, dtype=torch.int64, device=dev).scatter_(
        0, h_order, rank_sorted)
    fits = (state.grid.cell_fill[cell_h3.long()] + cell_rank < M).reshape(A, N)
    gate = gate0 & torch.all(fits, dim=1)

    # compacting scatter: location a -> slots base[a] .. base[a]+N-1
    slot_rank = torch.cumsum(gate.to(torch.int32), 0).to(torch.int32) - 1
    base = state.count + slot_rank * N
    gate = gate & (base + N <= cap)
    dest = base[:, None] + torch.arange(N, dtype=torch.int32, device=dev)
    dest = torch.where(gate[:, None], dest, cap)  # cap -> dropped

    pos = scatter_drop(state.pos, dest, new_pts.reshape(-1, 3))
    feat_init = 0.1 * draw.normal((AN, 2 * opts.c_dim))
    feat = scatter_drop(state.feat, dest, feat_init)
    n_loc = torch.sum(gate).to(torch.int32)
    count = state.count + n_loc * N

    # input (sensor) cloud: one point per gated location
    in_rank = state.in_count + slot_rank
    in_dest = torch.where(gate & (in_rank < opts.input_capacity), in_rank,
                          opts.input_capacity)
    in_pos = scatter_drop(state.in_pos, in_dest, pts_gt)
    in_rgb = scatter_drop(state.in_rgb, in_dest, gt_color)
    in_count = torch.clamp(state.in_count + n_loc, max=opts.input_capacity)

    # incremental index update: O(batch) instead of a full rebuild
    grid = knn.insert(state.grid, new_pts.reshape(-1, 3), dest.reshape(-1),
                      torch.repeat_interleave(gate, N))
    return MapState(pos=pos, feat=feat, count=count, grid=grid,
                    in_pos=in_pos, in_rgb=in_rgb, in_count=in_count), n_loc


def input_cloud_insert(state: MapState, opts: MapOptions, rays_o, rays_d,
                       gt_depth, gt_color, gate) -> MapState:
    """Append one sensor-space point per gated candidate to the input
    cloud (add_points' in_pos/in_rgb update, for the map-sharded path,
    where the neural points live on the shards and the input cloud is
    replicated)."""
    pts_gt = rays_o + rays_d * gt_depth[:, None]
    rank = torch.cumsum(gate.to(torch.int32), 0).to(torch.int32) - 1
    in_rank = state.in_count + rank
    in_dest = torch.where(gate & (in_rank < opts.input_capacity), in_rank,
                          opts.input_capacity)
    n_loc = torch.sum(gate).to(torch.int32)
    return state._replace(
        in_pos=scatter_drop(state.in_pos, in_dest, pts_gt),
        in_rgb=scatter_drop(state.in_rgb, in_dest, gt_color),
        in_count=torch.clamp(state.in_count + n_loc,
                             max=opts.input_capacity))


PROBE_INTERVALS = 25


def linspace01(n: int, device) -> torch.Tensor:
    """n float32 steps from 0 to 1 as XLA computes jnp.linspace(0, 1, n):
    i * float32(1 / (n - 1)), the last exactly 1 (torch.linspace rounds
    differently at n = 25)."""
    if n == 1:
        return torch.zeros(1, device=device)
    t = torch.arange(n, dtype=torch.float32, device=device) \
        * torch.tensor(1.0 / (n - 1), dtype=torch.float32, device=device)
    t[-1] = 1.0
    return t


def sample_near_pcl_z_vals(state: MapState, opts: MapOptions, rays_o,
                           rays_d, near, far, num: int):
    """sample_near_pcl_z_vals_raw over a map state, at its options'
    radius_query and nn_num."""
    return sample_near_pcl_z_vals_raw(state.pos, state.grid, rays_o, rays_d,
                                      near, far, num, opts.radius_query,
                                      opts.nn_num)


def probe_points(rays_o, rays_d, near, far):
    """The (R * 25, 3) probe points of sample_near_pcl_z_vals_raw, ray by
    ray, and their 25 depths."""
    t = linspace01(PROBE_INTERVALS, rays_o.device)
    z_probe = near * (1.0 - t) + far * t
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z_probe[None, :, None]
           ).reshape(-1, 3)
    return pts, z_probe


@torch.no_grad()
def sample_near_pcl_z_vals_raw(pos, grid, rays_o, rays_d, near, far,
                               num: int, radius_query, nn_num: int,
                               occupied_fn=None):
    """z-vals for zero-depth rays, where the point cloud lies: probe 25
    depths in [near, far] on each ray, call a probe occupied when the
    k-NN finds a neighbour within the scalar radius_query, and place
    `num` samples between the first two occupied probes. A ray with fewer
    than two occupied probes falls back to [near, far] and is flagged
    invalid. far may be a device scalar. Returns (z_vals (R, num),
    invalid (R,)). One k-NN over R * 25 probe points (one kernel launch
    on the card); only its in-radius counts are read. occupied_fn(pts) ->
    bool (N,) replaces that local probe (the map-sharded path's ring probe
    over every shard, parallel/map_shard.py)."""
    R = rays_o.shape[0]
    dev = rays_o.device
    pts, z_probe = probe_points(rays_o, rays_d, near, far)
    if occupied_fn is None:
        _, _, nn_count = knn.query_chunked(grid, pos, pts, nn_num,
                                           radius_query)
        occupied = (nn_count > 0).reshape(R, PROBE_INTERVALS)
    else:
        occupied = occupied_fn(pts).reshape(R, PROBE_INTERVALS)
    invalid = torch.sum(occupied, dim=-1) < 2
    # argmax of an integer row returns the first maximum, as jnp.argmax
    first = torch.argmax(occupied.to(torch.int32), dim=-1)
    rows = torch.arange(R, device=dev)
    occupied2 = occupied.clone()
    occupied2[rows, first] = False
    second = torch.argmax(occupied2.to(torch.int32), dim=-1)
    near_t = torch.as_tensor(near, dtype=torch.float32, device=dev)
    far_t = torch.as_tensor(far, dtype=torch.float32, device=dev)
    z0 = torch.where(invalid, near_t, z_probe[first])
    z1 = torch.where(invalid, far_t, z_probe[second])
    t = linspace01(num, dev)
    z_vals = z0[:, None] * (1.0 - t) + z1[:, None] * t
    return z_vals, invalid
