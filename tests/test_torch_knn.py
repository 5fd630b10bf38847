"""The port's spatial-hash k-NN against the JAX package, on the CPU.

`_hash_cells`, `build`, `build_adaptive` and `insert` are bit-equal to JAX
(same packed cell_data layout); the plain PyTorch `query` is bit-equal to
JAX's `query` (whose Pallas kernel runs in interpret mode on the CPU) in
D, I and neighbor_num. The brute-force cases of tests/test_knn.py and
tests/test_knn_chunked.py are replayed on the port. The CUDA kernel is
held against the plain version in tests/test_torch_knn_cuda.py (card only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loopy_slam_torch.ops import knn as tk
from loopy_slam_tpu.ops import knn as jk


def bits(a):
    return np.asarray(a).view(np.int32)


def t(a):
    return torch.as_tensor(np.asarray(a))


def make_points(rng, cap=3000, n=2500, lo=-0.5, hi=0.5):
    pts = rng.uniform(lo, hi, (cap, 3)).astype(np.float32)
    return pts, np.arange(cap) < n


def assert_grid_equal(gt, gj):
    np.testing.assert_array_equal(bits(gt.cell_data.numpy()),
                                  bits(gj.cell_data))
    np.testing.assert_array_equal(gt.cell_fill.numpy(),
                                  np.asarray(gj.cell_fill))
    assert int(gt.n_dropped) == int(gj.n_dropped)
    assert float(gt.cell_size) == float(gj.cell_size)


def test_hash_cells_bit_equal(rng):
    ijk = rng.integers(-2 ** 20, 2 ** 20, size=(5000, 3)).astype(np.int32)
    ijk[:10] = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(10, 3))
    for T in (2 ** 10, 2 ** 17):
        np.testing.assert_array_equal(
            tk._hash_cells(t(ijk), T).numpy(),
            np.asarray(jk._hash_cells(jnp.asarray(ijk), T)))
    p = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(tk._cell_of(t(p), 0.08).numpy(),
                                  np.asarray(jk._cell_of(jnp.asarray(p),
                                                         jnp.float32(0.08))))


@pytest.mark.parametrize("M", [16, 32, 64, 128])
def test_build_and_insert_bit_equal(rng, M):
    # a 1024-row table for 2500 points: hash-merged rows, some overflow at M=16
    pts, valid = make_points(rng)
    gj = jk.build(jnp.asarray(pts), jnp.asarray(valid), 0.1, 2 ** 10, M)
    gt = tk.build(t(pts), t(valid), 0.1, 2 ** 10, M)
    assert_grid_equal(gt, gj)
    new = rng.uniform(-0.5, 0.5, (200, 3)).astype(np.float32)
    idx = np.arange(2500, 2700).astype(np.int32)
    nv = rng.uniform(size=200) < 0.8
    assert_grid_equal(tk.insert(gt, t(new), t(idx), t(nv)),
                      jk.insert(gj, 2 ** 10, jnp.asarray(new),
                                jnp.asarray(idx), jnp.asarray(nv)))


def test_build_adaptive_escalation_equal(rng):
    pts, valid = make_points(rng, cap=4000, n=4000, lo=-0.2, hi=0.2)
    gj = jk.build_adaptive(jnp.asarray(pts), jnp.asarray(valid), 0.1,
                           2 ** 8, 4)
    gt = tk.build_adaptive(t(pts), t(valid), 0.1, 2 ** 8, 4)
    assert gt.cell_data.shape[1] > 4  # the ladder escalated
    assert_grid_equal(gt, gj)


@pytest.mark.parametrize("per_query_radius", [False, True])
@pytest.mark.parametrize("M", [16, 32, 64, 128])
def test_query_bit_equal(rng, M, per_query_radius):
    pts, valid = make_points(rng)
    gj = jk.build(jnp.asarray(pts), jnp.asarray(valid), 0.1, 2 ** 10, M)
    gt = tk.build(t(pts), t(valid), 0.1, 2 ** 10, M)
    q = rng.uniform(-0.6, 0.6, (400, 3)).astype(np.float32)
    r = (rng.uniform(0.02, 0.1, 400).astype(np.float32) if per_query_radius
         else np.float32(0.06))
    Dj, Ij, nj = jk.query(gj, jnp.asarray(pts), jnp.asarray(q), 8,
                          jnp.asarray(r), 2 ** 10, M)
    Dt, It, nt = tk.query(gt, t(pts), t(q), 8, t(r))
    np.testing.assert_array_equal(bits(Dt.numpy()), bits(Dj))
    np.testing.assert_array_equal(It.numpy(), np.asarray(Ij))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert nt.numpy().sum() > 0


def test_query_empty_map_and_stencil_collisions(rng):
    cap = 256
    q = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    zeros = np.zeros((cap, 3), np.float32)
    empty = np.zeros(cap, bool)
    # a 4-row table: most of a query's 27 stencil probes share a row and
    # must be redirected to the overflow row
    for T, pts, valid in ((2 ** 10, zeros, empty),
                          (4, *make_points(rng, cap=300, n=40))):
        gj = jk.build(jnp.asarray(pts), jnp.asarray(valid), 0.2, T, 64)
        gt = tk.build(t(pts), t(valid), 0.2, T, 64)
        Dj, Ij, nj = jk.query(gj, jnp.asarray(pts), jnp.asarray(q), 8, 0.2,
                              T)
        Dt, It, nt = tk.query(gt, t(pts), t(q), 8, 0.2)
        np.testing.assert_array_equal(bits(Dt.numpy()), bits(Dj))
        np.testing.assert_array_equal(It.numpy(), np.asarray(Ij))
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    h = tk.stencil_rows(gt, t(q))
    assert (h == 4).any()  # duplicates were redirected


# --- brute-force cases of tests/test_knn.py, replayed on the port -------

TABLE = 2 ** 16


def build_random(rng, n=500, cap=1024, cell=0.4):
    pts = rng.uniform(-1.0, 1.0, size=(cap, 3)).astype(np.float32)
    valid = np.zeros(cap, bool)
    valid[:n] = True
    grid = tk.build(t(pts), t(valid), cell, TABLE, max_per_cell=32)
    return pts, valid, grid


def test_knn_matches_brute_force(rng):
    cell = 0.4
    pts, valid, grid = build_random(rng, cell=cell)
    q = rng.uniform(-0.9, 0.9, size=(64, 3)).astype(np.float32)
    r = cell
    assert int(grid.n_dropped) == 0
    D, I, nn = tk.query(grid, t(pts), t(q), 8, r)
    Db, _ = tk.brute_force_knn(t(pts), t(valid), t(q), 8)
    D, Db, nn = D.numpy(), Db.numpy(), nn.numpy()
    for qi in range(q.shape[0]):
        exact_in = np.sort(Db[qi][Db[qi] < r ** 2])
        ours_in = np.sort(D[qi][D[qi] < r ** 2])
        assert len(ours_in) == len(exact_in) == nn[qi]
        np.testing.assert_allclose(ours_in, exact_in, rtol=3e-4)


def test_knn_distances_sorted_and_indices_consistent(rng):
    pts, valid, grid = build_random(rng)
    q = rng.uniform(-0.9, 0.9, size=(32, 3)).astype(np.float32)
    D, I, nn, pos = tk.query(grid, t(pts), t(q), 8, 0.2, return_pos=True)
    D, I, pos = D.numpy(), I.numpy(), pos.numpy()
    assert (np.diff(D, axis=-1) >= -1e-6).all()
    for qi in range(q.shape[0]):
        for k in range(8):
            if D[qi, k] < 1e9:
                d2 = np.sum((pts[I[qi, k]] - q[qi]) ** 2)
                np.testing.assert_allclose(D[qi, k], d2, rtol=3e-4)
                assert D[qi, k] >= d2 * (1 - 1e-6)
                np.testing.assert_array_equal(pos[qi, k], pts[I[qi, k]])


def test_knn_no_duplicate_neighbors(rng):
    pts, valid, grid = build_random(rng, n=300)
    q = pts[:50] + 1e-3
    D, I, nn = tk.query(grid, t(pts), t(q), 8, 0.2)
    D, I = D.numpy(), I.numpy()
    for qi in range(q.shape[0]):
        real = I[qi][D[qi] < 1e9]
        assert len(np.unique(real)) == len(real)


def test_per_query_radius(rng):
    pts, valid, grid = build_random(rng)
    q = rng.uniform(-0.9, 0.9, size=(16, 3)).astype(np.float32)
    radii = np.full(16, 0.05, np.float32)
    radii[8:] = 0.2
    _, _, nn = tk.query(grid, t(pts), t(q), 8, t(radii))
    _, _, nn2 = tk.query(grid, t(pts), t(q), 8, 0.05)
    assert (nn.numpy()[:8] == nn2.numpy()[:8]).all()
    assert (nn.numpy()[8:] >= nn2.numpy()[8:]).all()


def test_incremental_insert_matches_rebuild(rng):
    cell, cap = 0.4, 1024
    pts = rng.uniform(-1.0, 1.0, size=(cap, 3)).astype(np.float32)
    valid = np.zeros(cap, bool)
    valid[:300] = True
    grid = tk.build(t(pts), t(valid), cell, TABLE)
    for lo, hi in ((300, 400), (400, 500)):
        grid = tk.insert(grid, t(pts[lo:hi]),
                         torch.arange(lo, hi, dtype=torch.int32),
                         torch.ones(hi - lo, dtype=torch.bool))
        valid[lo:hi] = True
    full = tk.build(t(pts), t(valid), cell, TABLE)
    q = rng.uniform(-0.9, 0.9, size=(64, 3)).astype(np.float32)
    D1, I1, n1 = tk.query(grid, t(pts), t(q), 8, cell / 2)
    D2, I2, n2 = tk.query(full, t(pts), t(q), 8, cell / 2)
    np.testing.assert_array_equal(n1.numpy(), n2.numpy())
    np.testing.assert_array_equal(D1.numpy(), D2.numpy())


def test_query_chunked_matches_unchunked():
    rng = np.random.default_rng(5)
    cell, M, T = 0.1, 16, 2 ** 12
    pts = t(rng.uniform(0, 1.0, (3000, 3)).astype(np.float32))
    g = tk.build(pts, torch.ones(len(pts), dtype=torch.bool), cell, T, M)
    q = t(rng.uniform(0, 1.0, (1000, 3)).astype(np.float32))
    for radius in (0.05, t(rng.uniform(0.02, 0.09, 1000).astype(np.float32))):
        D0, I0, n0 = tk.query(g, pts, q, 8, radius)
        D1, I1, n1 = tk.query_chunked(g, pts, q, 8, radius, chunk=300)
        assert torch.equal(I0, I1) and torch.equal(n0, n1)
        assert torch.equal(D0.view(torch.int32), D1.view(torch.int32))



# --- the invariant the CUDA kernel relies on: rows filled from slot 0 ----

def grid_of_kind(kind, rng):
    """(torch grid, points) for each way the port's grids are made."""
    if kind == "build":  # 2500 points in 1024 rows: some rows overflow
        pts, valid = make_points(rng)
        return tk.build(t(pts), t(valid), 0.1, 2 ** 10, 16), pts
    if kind == "build_adaptive":
        pts, valid = make_points(rng, cap=4000, n=4000, lo=-0.2, hi=0.2)
        return tk.build_adaptive(t(pts), t(valid), 0.1, 2 ** 8, 4), pts
    if kind == "insert":  # repeated inserts into full rows: drops
        pts = rng.uniform(-0.3, 0.3, (4000, 3)).astype(np.float32)
        valid = np.arange(4000) < 500
        g = tk.build(t(pts), t(valid), 0.1, 2 ** 10, 16)
        for lo in range(500, 4000, 700):
            hi = min(lo + 700, 4000)
            nv = rng.uniform(size=hi - lo) < 0.9
            g = tk.insert(g, t(pts[lo:hi]), torch.arange(lo, hi).int(), t(nv))
        assert int(g.n_dropped) > 0
        return g, pts
    assert kind == "jax_convert"  # a JAX grid, built then grown by insert
    from loopy_slam_torch.convert import map_state_from_numpy

    pts, valid = make_points(rng)
    gj = jk.build(jnp.asarray(pts), jnp.asarray(valid), 0.1, 2 ** 10, 16)
    gj = jk.insert(gj, 2 ** 10, jnp.asarray(pts[2500:]),
                   jnp.arange(2500, 3000, dtype=jnp.int32),
                   jnp.ones(500, bool))
    state = map_state_from_numpy(
        pts, np.zeros((3000, 4), np.float32), 3000, np.asarray(gj.cell_data),
        np.asarray(gj.cell_fill), np.asarray(gj.cell_size),
        np.asarray(gj.n_dropped), device="cpu")
    return state.grid, pts


GRID_KINDS = ["build", "build_adaptive", "insert", "jax_convert"]


@pytest.mark.parametrize("kind", GRID_KINDS)
def test_rows_filled_from_slot_zero(rng, kind):
    """Slots [0, cell_fill[h]) of every row hold real points and slots
    [cell_fill[h], M) the empty sentinel; the overflow row has fill 0."""
    g, pts = grid_of_kind(kind, rng)
    T, M = g.cell_data.shape[0] - 1, g.cell_data.shape[1]
    assert g.cell_fill.dtype == torch.int32 and g.cell_fill.shape == (T + 1,)
    assert int(g.cell_fill[T]) == 0
    fill = g.cell_fill.long()
    filled = torch.arange(M)[None, :] < fill[:, None]
    words = g.cell_data.view(torch.int32)
    empty = (words == tk._empty_row("cpu").view(torch.int32)).all(-1)
    assert torch.equal(empty, ~filled)
    # a filled slot holds a point of the buffer, at its own coordinates
    idx = (words[..., 3][filled] & (tk._IDX_TAG - 1)).long()
    assert bool(((words[..., 3][filled] & tk._IDX_TAG) != 0).all())
    assert bool((idx < len(pts)).all())
    np.testing.assert_array_equal(g.cell_data[filled][:, :3].numpy(),
                                  pts[idx.numpy()])


def query_filled_slots(grid, queries, k, radius):
    """The k-NN function read as the CUDA kernel reads it: only the slots
    [0, cell_fill[h]) of each stencil row (a redirected repeat probe reads
    the overflow row, whose fill is 0), keyed by the same probe * M + slot
    ids; a skipped slot leaves the exhausted key 0x7fffffff."""
    T, M = grid.cell_data.shape[0] - 1, grid.cell_data.shape[1]
    Q, S = queries.shape[0], tk._S
    id_mask = (1 << tk._id_bits(M)) - 1
    h = tk.stencil_rows(grid, queries)
    rows = grid.cell_data[h]  # (Q, S, M, 4)
    read = torch.arange(M) < grid.cell_fill.long()[h][..., None]
    d = rows[..., :3] - queries[:, None, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    gid = (torch.arange(S)[:, None] * M + torch.arange(M)).int()
    key = (d2.view(torch.int32) & ~id_mask) | gid
    key = torch.where(read, key, 0x7fffffff).reshape(Q, S * M)
    top, pos = torch.topk(key, k, dim=1, largest=False, sorted=True)
    D = (top | id_mask).view(torch.float32)
    I = torch.gather(rows[..., 3].reshape(Q, S * M).view(torch.int32), 1,
                     pos) & (tk._IDX_TAG - 1)
    hit = D < 1e10
    I = torch.where(hit, I, 0)
    D = torch.where(hit, D, torch.full((), 1e10))
    r = torch.as_tensor(radius, dtype=torch.float32)
    r2 = (r * r)[:, None] if r.dim() == 1 else r * r
    return D, I, torch.sum(D < r2, dim=-1).to(torch.int32)


@pytest.mark.parametrize("kind", GRID_KINDS)
def test_filled_slot_scan_equals_plain(rng, kind):
    """Skipping the empty slots changes no output: bit-equal D, I and
    neighbor_num, with queries past the map (fewer than k candidates) and
    at negative coordinates, for k = 8 and 16 and a per-query radius."""
    g, _ = grid_of_kind(kind, rng)
    q = t(rng.uniform(-0.7, 0.7, (300, 3)).astype(np.float32))
    r = t(rng.uniform(0.02, 0.1, 300).astype(np.float32))
    for k, radius in ((8, 0.06), (16, r)):
        D, I, nn = query_filled_slots(g, q, k, radius)
        Dp, Ip, nnp = tk._query_plain(g, q, k, radius)
        assert torch.equal(D.view(torch.int32), Dp.view(torch.int32))
        assert torch.equal(I, Ip) and torch.equal(nn, nnp)
        assert bool((D == 1e10).any()) and int(nn.sum()) > 0


def stencil_has_repeat(base, T):
    """The CUDA kernel's test for a repeated hash among a query's 27 probes,
    in uint32 arithmetic as knn_select.cu does it: with X_i = ((b_x + i - 1)
    * P1) & mask (Y, Z alike), probe (i, j, l) hashes to X_i ^ Y_j ^ Z_l,
    so two probes collide iff some xor of per-axis differences
    X_i ^ X_i' (i < i') taken on one, two or three axes is 0."""
    mask = np.uint32(T - 1)
    b = base.astype(np.uint32)
    pairs = [(-1, 0), (-1, 1), (0, 1)]
    with np.errstate(over="ignore"):
        d = [[(((b[:, ax] + np.uint32(lo & 0xffffffff)) * np.uint32(p))
               ^ ((b[:, ax] + np.uint32(hi & 0xffffffff)) * np.uint32(p)))
              & mask for lo, hi in pairs]
             for ax, p in enumerate((tk._P1, tk._P2, tk._P3))]
    hit = np.zeros(len(base), bool)
    for dx in d[0]:
        for dy in d[1]:
            for dz in d[2]:
                hit |= ((dx == 0) | (dy == 0) | (dz == 0) | (dx == dy)
                        | (dx == dz) | (dy == dz) | (dx == (dy ^ dz)))
    return hit


@pytest.mark.parametrize("T", [1, 4, 2 ** 10, 2 ** 17])
def test_stencil_repeat_test_is_exact(rng, T):
    """The kernel runs __match_any_sync only where this test fires, so it
    must find every repeated probe hash (and, to stay cheap, few others):
    held against the 27 hashes themselves, for base cells near the origin
    and anywhere in int32."""
    base = rng.integers(-2 ** 31, 2 ** 31, size=(6000, 3))
    base[:1000] = rng.integers(-40, 40, size=(1000, 3))
    h = tk._hash_cells(torch.as_tensor(base, dtype=torch.int32)[:, None, :]
                       + torch.as_tensor(tk._OFFSETS27)[None], T).numpy()
    repeated = np.array([len(np.unique(r)) < tk._S for r in h])
    np.testing.assert_array_equal(stencil_has_repeat(base, T), repeated)
    if T <= 2 ** 10:
        assert repeated.any()
