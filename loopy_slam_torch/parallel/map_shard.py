"""Map sharding: the point buffer, its features and its hash grid split
over the ranks by hash-cell ownership, with ring collectives for the k-NN.

Port of loopy_slam_tpu/parallel/map_shard.py over torch.distributed
(parallel/mesh.py). Every rank holds only its own shard (`ShardedMap`,
the local view of JAX's stacked arrays); the session runs the same calls
on every rank, as shard_map runs one program on every device.

  Ownership. Every hash cell has one owner rank, chosen by a hash of its
  coordinates (owner_of_cells, with int32 wrap-around and primes other
  than the table hash's), so a cell's candidate row is complete on its
  owner and the 27-cell stencil query stays exact.

  Insertion. The candidate batch is replicated (the same draws on every
  rank); each rank keeps the rows whose cell it owns (shard_insert,
  shard_add_candidates). The insertion gate needs a global k-NN (a ring
  pass with k = 1) and the owner's row fill (one psum).

  k-NN: a ring top-k. Each rank's queries, radii and running best
  (D, local index, owner) visit every rank; at each stop the holder runs
  the single-device k-NN (ops/knn.query: the knn_select kernel on the
  card) on its local grid and a stable 2k -> k merge follows (ring_knn).

  Feature fetch: a second ring fills each (owner, index) pair from the
  owner's packed [feat || pos] rows (ring_fetch). Its backward runs the
  ring the other way and index_adds each rank's share into its own
  feature gradient, so feature gradients never leave their shard.

  Decode: the fetched block goes through the single-device
  decode_neighbors (ring_eval_points), the eval_fn hook of
  render_batch_ray; the optimizer and the tracker run with it
  (map_shard_optimize, map_shard_track) and psum only the replicated
  gradients (decoders, exposure, poses).

Session helpers: the PGO transform of every shard (shard_transform),
growth (grow_sharded), the gathered snapshot (gather_host) and the
rebuild from host points (scatter_from_host); the frustum mask is
mapper.frustum_feature_mask over a shard's points. Every shard's grid is
built by knn.build (shard_rebuild) at the configured table size and row
depth, so the insertion gate's hash rows are the same on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..mapping.mapper import _optimize_map_impl
from ..mapping.point_cloud import scatter_drop
from ..mapping.tracker import _track_frame_impl
from ..models.renderer import decode_neighbors
from ..ops import knn

# Cell-ownership mixing primes: other than the table-hash primes of
# ops/knn.py, so the owner is uncorrelated with the table slot.
_Q1, _Q2, _Q3 = 92837111, 689287499, 283923481


def owner_of_cells(ijk: torch.Tensor, n_shards: int) -> torch.Tensor:
    """int32 cell coords (..., 3) -> owning rank in [0, n_shards); int32
    multiply wrap-around, as the JAX hash."""
    ijk = ijk.to(torch.int32)
    h = (ijk[..., 0] * _Q1) ^ (ijk[..., 1] * _Q2) ^ (ijk[..., 2] * _Q3)
    return h & (n_shards - 1)


def owner_of_points(pts: torch.Tensor, cell_size, n_shards: int):
    return owner_of_cells(knn._cell_of(pts, cell_size), n_shards)


def owner_of_points_np(pts, cell_size, n_shards: int):
    """Host mirror of owner_of_points (numpy int32 wrap-around)."""
    ijk = np.floor(np.asarray(pts, np.float32)
                   / np.float32(cell_size)).astype(np.int32)
    with np.errstate(over="ignore"):
        h = ((ijk[:, 0] * np.int32(_Q1)) ^ (ijk[:, 1] * np.int32(_Q2))
             ^ (ijk[:, 2] * np.int32(_Q3)))
    return h & np.int32(n_shards - 1)


class ShardedMap(NamedTuple):
    """This rank's shard: every rank has the same capacity."""

    pos: torch.Tensor    # (cap_l, 3)
    feat: torch.Tensor   # (cap_l, 2c)
    count: torch.Tensor  # () int32 valid prefix
    grid: knn.HashGrid   # index over pos[:count]


def shard_rebuild(pos, count, mopts) -> knn.HashGrid:
    """The index of a shard's pos[:count]."""
    valid = torch.arange(pos.shape[0], device=pos.device) < count
    return knn.build(pos, valid, mopts.cell_size, mopts.table_size,
                     mopts.max_per_cell)


def init_sharded_map(cap_local: int, mopts, device) -> ShardedMap:
    """An empty shard of cap_local rows."""
    pos = torch.zeros((cap_local, 3), device=device)
    count = torch.zeros((), dtype=torch.int32, device=device)
    return ShardedMap(pos=pos,
                      feat=torch.zeros((cap_local, 2 * mopts.c_dim),
                                       device=device),
                      count=count, grid=shard_rebuild(pos, count, mopts))


def _compact_insert(s: ShardedMap, mine, new_pts, new_feat) -> ShardedMap:
    """Append the rows of `mine` to the shard, in order, past its count;
    rows beyond its capacity drop."""
    cap_l = s.pos.shape[0]
    rank = torch.cumsum(mine.to(torch.int32), 0).to(torch.int32) - 1
    dest = s.count + rank
    ok = mine & (dest < cap_l)
    dest = torch.where(ok, dest, cap_l)
    return ShardedMap(
        pos=scatter_drop(s.pos, dest, new_pts),
        feat=scatter_drop(s.feat, dest, new_feat),
        count=s.count + torch.sum(ok).to(torch.int32),
        grid=knn.insert(s.grid, new_pts, dest, ok))


def shard_insert(smap: ShardedMap, mesh, new_pts, new_feat, new_valid,
                 cell_size) -> ShardedMap:
    """Insert the rows of a replicated batch whose cell this rank owns."""
    mine = new_valid & (owner_of_points(new_pts, cell_size, mesh.size())
                        == mesh.rank)
    return _compact_insert(smap, mine, new_pts, new_feat)


def _merge_topk(bestD, bestI, bestO, D_new, I_new, O_new, k: int):
    """The k smallest of two (Q, k) candidate sets by D; a stable sort, so
    ties keep their order (jax.lax.top_k's). No point is seen twice: each
    lives on one shard and each shard is visited once."""
    D = torch.cat([bestD, D_new], dim=1)
    I = torch.cat([bestI, I_new], dim=1)
    O = torch.cat([bestO, O_new], dim=1)
    D, sel = torch.sort(D, dim=1, stable=True)
    sel = sel[:, :k]
    return D[:, :k], torch.gather(I, 1, sel), torch.gather(O, 1, sel)


def ring_knn(smap: ShardedMap, mesh, queries, k: int, radius):
    """Global k-NN of this rank's queries (Qd, 3) over every shard. radius:
    a scalar or (Qd,). Returns (D, I, owner, neighbor_num): I is a local
    row index on the owner rank; owner -1 and D 1e10 where empty."""
    me, n = mesh.rank, mesh.size()
    Qd = queries.shape[0]
    dev = queries.device
    r = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    rr = r.expand(Qd).contiguous() if r.dim() == 0 else r.contiguous()
    q = queries.contiguous()
    bestD = torch.full((Qd, k), 1e10, device=dev)
    bestI = torch.zeros((Qd, k), dtype=torch.int32, device=dev)
    bestO = torch.full((Qd, k), -1, dtype=torch.int32, device=dev)
    for _ in range(n):
        D_loc, I_loc, _ = knn.query(smap.grid, smap.pos, q, k, rr)
        O_loc = torch.where(D_loc < 1e10, me, -1).to(torch.int32)
        bestD, bestI, bestO = _merge_topk(bestD, bestI, bestO, D_loc, I_loc,
                                          O_loc, k)
        q, rr, bestD, bestI, bestO = mesh.ring_shift(
            [q, rr, bestD, bestI, bestO], 1)
    nn = torch.sum(bestD < (rr * rr)[:, None], dim=-1).to(torch.int32)
    return bestD, bestI, bestO, nn


class _RingFetch(torch.autograd.Function):
    """[feat || pos] rows of (owner, local index) pairs around the ring;
    the backward reverses the ring and index_adds each rank's share of the
    feature gradient into its own rows (positions take none)."""

    @staticmethod
    def forward(ctx, feat, pos, I, owner, mesh):
        me, n = mesh.rank, mesh.size()
        Qd, k = I.shape
        featpos = torch.cat([feat, pos], dim=1)
        F = featpos.shape[1]
        acc = featpos.new_zeros((Qd, k, F))
        Ir, Or = I.contiguous(), owner.contiguous()
        hops = []
        for _ in range(n):
            hops.append((Ir, Or))
            vals = featpos.index_select(0, Ir.reshape(-1).long()).reshape(
                Qd, k, F)
            acc = torch.where((Or == me)[..., None], vals, acc)
            Ir, Or, acc = mesh.ring_shift([Ir, Or, acc], 1)
        ctx.hops, ctx.mesh, ctx.fshape = hops, mesh, feat.shape
        return acc

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        c2 = ctx.fshape[1]
        dfeat = g.new_zeros(ctx.fshape)
        g = g[..., :c2].contiguous()
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        for Ir, Or in reversed(ctx.hops):
            (g,) = mesh.ring_shift([g], -1)
            mine = (Or == mesh.rank)[..., None]
            dfeat.index_add_(0, Ir.reshape(-1).long(),
                             torch.where(mine, g, zero).reshape(-1, c2))
            g = torch.where(mine, zero, g)
        return dfeat, None, None, None, None


def ring_fetch(feat, pos, I, owner, mesh):
    """(Qd, k, 2c + 3) packed rows of the (owner, I) pairs; differentiable
    in feat only."""
    return _RingFetch.apply(feat, pos.detach(), I, owner, mesh)


def ring_eval_points(smap: ShardedMap, mesh, dec, pts, draw, opts, stage,
                     views_d=None, r_query=None, exposure_feat=None,
                     exposure_mlp=None):
    """eval_points over the sharded map: ring k-NN + ring fetch + the
    single-device decode."""
    rq = opts.radius_query if r_query is None else r_query
    D, I, owner, nn = ring_knn(smap, mesh, pts.detach(), opts.nn_num, rq)
    both = ring_fetch(smap.feat, smap.pos, I, owner, mesh)
    return decode_neighbors(dec, pts, draw, opts, stage, D, both, nn, rq,
                            views_d, exposure_feat, exposure_mlp)


def eval_fn_builder(smap: ShardedMap, mesh, ropts):
    """A function of (dec, feats) that returns an eval_fn over this shard
    with `feats` as its features, for render_batch_ray; with
    sample_near_pcl its `probe_occupied` runs the probe as a ring pass
    (k = 1)."""
    def build(dec, feats):
        s = smap._replace(feat=feats)

        def eval_fn(pts, draw, stage, views_d, rq, exposure_feat,
                    exposure_mlp):
            return ring_eval_points(s, mesh, dec, pts, draw, ropts, stage,
                                    views_d, rq, exposure_feat, exposure_mlp)

        if ropts.sample_near_pcl:
            def probe_occupied(pts):
                _, _, _, nn = ring_knn(s, mesh, pts, 1, ropts.radius_query)
                return nn > 0

            eval_fn.probe_occupied = probe_occupied
        return eval_fn

    return build


@torch.no_grad()
def shard_add_candidates(smap: ShardedMap, mesh, mopts, rays_o, rays_d, d,
                         draw, valid, r_add):
    """Surface-point insertion over the sharded map, as
    point_cloud.add_points: a candidate passes with no neighbour within
    r_add (A,) on any shard (a ring pass, k = 1) and a free slot for each
    of its N_add spawned points in the owner's hash row (the owner's fill,
    by psum); each spawned point goes to the rank owning its cell. Inputs
    and the feature draws (A * N_add, 2c) are replicated, so the gate is
    the same on every rank. Returns (smap', n_locations, gate)."""
    me, n = mesh.rank, mesh.size()
    dev = rays_o.device
    valid = valid & (d > 0)
    pts_gt = rays_o + rays_d * d[:, None]
    _, _, _, nn = ring_knn(smap, mesh, pts_gt, 1, r_add)
    gate0 = valid & (nn == 0)
    A = pts_gt.shape[0]
    N = mopts.N_add
    if mopts.fix_interval_when_add_along_ray:
        z = d[:, None] + torch.linspace(-0.04, 0.04, N, device=dev)
    else:
        t = torch.linspace(0.0, 1.0, N, device=dev)
        z = (mopts.near_end_surface * d[:, None] * (1.0 - t)
             + mopts.far_end_surface * d[:, None] * t)
    new_pts = (rays_o[:, None, :]
               + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
    M = smap.grid.cell_data.shape[1]
    T = smap.grid.cell_data.shape[0] - 1
    AN = A * N
    cell_h3 = knn._hash_cells(knn._cell_of(new_pts, smap.grid.cell_size), T)
    own3 = owner_of_points(new_pts, mopts.cell_size, n) == me
    fill3, = mesh.psum([torch.where(own3, smap.grid.cell_fill[cell_h3.long()],
                                    0).to(torch.float32)])
    key_h = torch.where(torch.repeat_interleave(gate0, N), cell_h3, T)
    h_order = torch.argsort(key_h, stable=True)
    cs = key_h[h_order].contiguous()
    first = torch.searchsorted(cs, cs, side="left")
    rank_sorted = torch.arange(AN, device=dev) - first
    cell_rank = torch.zeros(AN, dtype=torch.int64, device=dev).scatter_(
        0, h_order, rank_sorted)
    fits = (fill3.to(torch.int64) + cell_rank < M).reshape(A, N)
    gate = gate0 & torch.all(fits, dim=1)
    mine = torch.repeat_interleave(gate, N) & own3
    feat_init = 0.1 * draw.normal((AN, 2 * mopts.c_dim))
    smap = _compact_insert(smap, mine, new_pts, feat_init)
    return smap, torch.sum(gate).to(torch.int32), gate


def map_shard_optimize(mesh, dec, feat, adam_state, dec_mask, feat_mask,
                       smap: ShardedMap, kf_color, kf_depth, kf_c2w, draw,
                       n_geo_iters, n_col_iters, lrs_geo, lrs_col, opts,
                       ropts, pix_per_frame: int, **kw):
    """mapper.optimize_map over the sharded map: this rank's features
    `feat` (cap_l, 2c) and frustum mask, pix_per_frame / n rays a frame
    from this rank's `draw`, the sample decode through the ring, the
    replicated gradients (decoders, exposure, poses) summed, the feature
    gradient local. kw: optimize_map's keywords (kf_rq, kf_exposure, exp,
    BA's cams, ba_row_mask, ba_lr, ba_window, iter_offset)."""
    local_pix = max(pix_per_frame // mesh.size(), 1)
    return _optimize_map_impl(
        dec, feat, adam_state, dec_mask, feat_mask, smap.pos, smap.grid,
        kf_color, kf_depth, kf_c2w, draw, n_geo_iters, n_col_iters, lrs_geo,
        lrs_col, opts, ropts, local_pix, mesh=mesh,
        eval_fn_builder=eval_fn_builder(smap, mesh, ropts),
        feat_grad_local=True, **kw)


def map_shard_track(mesh, dec, smap: ShardedMap, gt_color, gt_depth,
                    cam7_init, draw, opts, ropts, **kw):
    """tracker.track_frame over the sharded map: opts.pixels / n rays an
    iteration on this rank from its `draw`, the decode through the ring,
    loss and pose (and exposure) gradients summed. kw: track_frame's
    keywords (health, sel_i, sel_j, r_query, exposure_feat)."""
    opts_l = opts._replace(pixels=max(opts.pixels // mesh.size(), 1))
    return _track_frame_impl(
        dec, smap.pos, smap.grid, smap.feat, gt_color, gt_depth, cam7_init,
        draw, opts_l, ropts, mesh=mesh,
        eval_fn_builder=eval_fn_builder(smap, mesh, ropts), **kw)


def shard_transform(smap: ShardedMap, N: torch.Tensor, mopts) -> ShardedMap:
    """The rigid 4x4 N applied to this shard's points, its index rebuilt
    (the PGO correction of the active segment). Cell ownership is not
    re-decided: a moved point stays on its rank."""
    pos = smap.pos @ N[:3, :3].T + N[:3, 3]
    return smap._replace(pos=pos,
                         grid=shard_rebuild(pos, smap.count, mopts))


def grow_sharded(smap: ShardedMap, new_cap_l: int, mopts) -> ShardedMap:
    """The shard at a larger capacity (every rank grows alike)."""
    cap_l = smap.pos.shape[0]
    dev = smap.pos.device
    pos = torch.zeros((new_cap_l, 3), device=dev)
    pos[:cap_l] = smap.pos
    feat = torch.zeros((new_cap_l, smap.feat.shape[1]), device=dev)
    feat[:cap_l] = smap.feat
    return ShardedMap(pos=pos, feat=feat, count=smap.count,
                      grid=shard_rebuild(pos, smap.count, mopts))


@torch.no_grad()
def gather_host(smap: ShardedMap, mesh):
    """Every shard's valid rows in rank order, on every rank: (pos (N, 3),
    feat (N, 2c), per-rank counts as numpy)."""
    n = int(smap.count)
    pos = mesh.all_gather_rows(smap.pos[:n])
    feat = mesh.all_gather_rows(smap.feat[:n].detach())
    counts = mesh.all_gather_rows(smap.count.reshape(1).to(torch.float32))
    return pos, feat, counts.cpu().numpy().astype(np.int64)


def scatter_from_host(mesh, pos_np, feat_np, cap_local: int, mopts,
                      device) -> ShardedMap:
    """This rank's shard of host points (every rank passes the same
    arrays): the rows whose cell it owns, in order (segment carry-over,
    the merged map, restore). Raises on every rank alike when a shard
    needs more than cap_local rows."""
    n = mesh.size()
    pos_np = np.asarray(pos_np, np.float32).reshape(-1, 3)
    feat_np = np.asarray(feat_np, np.float32).reshape(pos_np.shape[0], -1)
    owners = owner_of_points_np(pos_np, mopts.cell_size, n)
    counts = np.bincount(owners, minlength=n)
    if counts.max(initial=0) > cap_local:
        raise ValueError(
            f"shard {int(counts.argmax())} needs {int(counts.max())} rows > "
            f"per-shard capacity {cap_local}; increase pointcloud capacity")
    rows = owners == mesh.rank
    cnt = int(rows.sum())
    pos = torch.zeros((cap_local, 3), device=device)
    feat = torch.zeros((cap_local, 2 * mopts.c_dim), device=device)
    if cnt:
        pos[:cnt] = torch.as_tensor(pos_np[rows], device=device)
        feat[:cnt] = torch.as_tensor(feat_np[rows], device=device)
    count = torch.tensor(cnt, dtype=torch.int32, device=device)
    return ShardedMap(pos=pos, feat=feat, count=count,
                      grid=shard_rebuild(pos, count, mopts))
