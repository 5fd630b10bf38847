"""The CUDA k-NN kernel (loopy_slam_torch/csrc/knn_select.cu) against its
plain PyTorch version, on the card, and the cost counter
(utils/cost.CostCounter) there: the kernel's reported cost equals the plain
route's, and autograd's backward (on the engine's CUDA thread) is counted.
Skips without a card.

Imports neither jax nor the JAX package, so it also runs on a machine that
has neither (the repo's conftest imports jax, hence --noconftest there):

    python -m pytest --noconftest -m cuda tests/test_torch_knn_cuda.py
"""

import numpy as np
import pytest
import torch

from loopy_slam_torch.ops import knn
from loopy_slam_torch.utils.cost import CostCounter

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


def grid_and_queries(dev, M, Q=5000, T=2 ** 10, seed=0):
    """2500 points in a 1024-row table: hash-merged rows, overflow at M=16."""
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.uniform(-0.5, 0.5, (3000, 3)).astype(np.float32))
    valid = torch.arange(3000) < 2500
    g = knn.build(pts.to(dev), valid.to(dev), 0.1, T, M)
    q = torch.as_tensor(rng.uniform(-0.6, 0.6, (Q, 3)).astype(np.float32))
    r = torch.as_tensor(rng.uniform(0.02, 0.1, Q).astype(np.float32))
    return g, q.to(dev), r.to(dev)


def assert_kernel_equals_plain(g, q, k, radius):
    D, I, nn = knn._query_cuda(g, q, k, radius)
    torch.cuda.synchronize()
    Dp, Ip, nnp = knn._query_plain(g, q, k, radius)
    assert torch.equal(D.view(torch.int32), Dp.view(torch.int32))
    assert torch.equal(I, Ip) and torch.equal(nn, nnp)
    return D, I, nn


@pytest.mark.parametrize("k", [1, 5, 8, 16])
@pytest.mark.parametrize("per_query_radius", [False, True])
@pytest.mark.parametrize("M", [16, 32, 128, 256])
def test_kernel_bit_equal_to_plain(dev, M, per_query_radius, k):
    """Q = 5000 is no multiple of a block's queries; the queries reach past
    the map (fewer than k candidates) and into negative coordinates."""
    g, q, r = grid_and_queries(dev, M)
    radius = r if per_query_radius else 0.06
    n0 = knn.KNN_SELECT_LAUNCHES.count
    D, I, nn = knn.query(g, None, q, k, radius)
    torch.cuda.synchronize()
    assert knn.KNN_SELECT_LAUNCHES.count == n0 + 1
    Dp, Ip, nnp = knn._query_plain(g, q, k, radius)
    assert torch.equal(D.view(torch.int32), Dp.view(torch.int32))
    assert torch.equal(I, Ip) and torch.equal(nn, nnp)
    assert int(nn.sum()) > 0
    if M == 16:  # 2500 points in 1024 rows overflow some rows: filled to M
        assert int(g.n_dropped) > 0
        assert int(g.cell_fill[:-1].max()) == M


@pytest.mark.parametrize("Q", [1, 33, 4999])
@pytest.mark.parametrize("k", [5, 16])
def test_kernel_partial_groups_and_blocks(dev, k, Q):
    """Query counts that leave a lane group, a warp and a block partly
    empty."""
    g, q, r = grid_and_queries(dev, 32, Q=Q, seed=2)
    assert_kernel_equals_plain(g, q, k, r)
    assert_kernel_equals_plain(g, q, k, 0.06)


def test_kernel_reads_no_slot_past_the_fill(dev):
    """A real point written at slot cell_fill[h] of the row each query's own
    cell hashes to, with cell_fill unchanged: the kernel must skip it and
    give the clean grid's answer, which the plain version (it reads every
    slot) does not."""
    g, q, r = grid_and_queries(dev, 32, Q=2000, seed=5)
    T, M = g.cell_data.shape[0] - 1, g.cell_data.shape[1]
    h = knn._hash_cells(knn._cell_of(q, g.cell_size), T).long()
    slot = g.cell_fill[h].long()
    open_ = slot < M
    assert int(open_.sum()) > 1000
    tag = torch.full((int(open_.sum()), 1), knn._IDX_TAG | 7,
                     dtype=torch.int32, device=dev).view(torch.float32)
    cd = g.cell_data.clone()
    cd[h[open_], slot[open_]] = torch.cat([q[open_], tag], dim=1)
    poisoned = g._replace(cell_data=cd)
    Dc, Ic, nnc = knn._query_plain(g, q, 8, r)
    _, Ip, _ = knn._query_plain(poisoned, q, 8, r)
    assert not torch.equal(Ic, Ip)  # the past-the-fill points are near
    D, I, nn = knn._query_cuda(poisoned, q, 8, r)
    torch.cuda.synchronize()
    assert torch.equal(D.view(torch.int32), Dc.view(torch.int32))
    assert torch.equal(I, Ic) and torch.equal(nn, nnc)


def test_kernel_rows_of_16_id_bits(dev):
    """M = 2427, the widest row 16 id bits hold, every row filled to M:
    22000 points in the 8 cells of [0, 0.2)^3 overflow each row."""
    rng = np.random.default_rng(3)
    M = 2427
    assert knn._id_bits(M) == 16
    pts = torch.as_tensor(rng.uniform(0, 0.2, (22000, 3)).astype(np.float32))
    g = knn.build(pts.to(dev), torch.ones(22000, dtype=torch.bool,
                                          device=dev), 0.1, 2 ** 10, M)
    fill = g.cell_fill[:-1]
    assert int(g.n_dropped) > 0 and int((fill == M).sum()) == 8
    q = torch.as_tensor(rng.uniform(-0.05, 0.25, (61, 3)).astype(np.float32))
    for k in (1, 16):
        assert_kernel_equals_plain(g, q.to(dev), k, 0.05)


def test_kernel_after_inserts_with_drops(dev):
    """A grid grown by insert (slot order differs from build's) until rows
    overflow, queried where some queries have fewer than k candidates."""
    rng = np.random.default_rng(4)
    pts = torch.as_tensor(rng.uniform(-0.3, 0.3, (4000, 3))
                          .astype(np.float32)).to(dev)
    valid = torch.zeros(4000, dtype=torch.bool, device=dev)
    valid[:500] = True
    g = knn.build(pts, valid, 0.1, 2 ** 12, 16)
    for lo in range(500, 4000, 700):
        hi = min(lo + 700, 4000)
        g = knn.insert(g, pts[lo:hi],
                       torch.arange(lo, hi, dtype=torch.int32, device=dev),
                       torch.ones(hi - lo, dtype=torch.bool, device=dev))
    assert int(g.n_dropped) > 0
    q = torch.as_tensor(rng.uniform(-0.6, 0.6, (3001, 3))
                        .astype(np.float32)).to(dev)
    r = torch.as_tensor(rng.uniform(0.02, 0.1, 3001).astype(np.float32))
    D, _, _ = assert_kernel_equals_plain(g, q, 16, r.to(dev))
    assert bool((D == 1e10).any()) and bool((D < 1e10).any())


def test_kernel_empty_map_and_stencil_collisions(dev):
    """A 4-row table (most stencil probes redirected) and an empty map."""
    g4, q, _ = grid_and_queries(dev, 64, Q=700, T=4, seed=1)
    empty = knn.build(torch.zeros(3000, 3, device=dev),
                      torch.zeros(3000, dtype=torch.bool, device=dev),
                      0.1, 2 ** 10, 64)
    for g in (g4, empty):
        D, I, nn = knn._query_cuda(g, q, 8, 0.1)
        Dp, Ip, nnp = knn._query_plain(g, q, 8, 0.1)
        assert torch.equal(D.view(torch.int32), Dp.view(torch.int32))
        assert torch.equal(I, Ip) and torch.equal(nn, nnp)


def test_kernel_rejects_what_it_does_not_take(dev):
    g, q, _ = grid_and_queries(dev, 32, Q=10)
    with pytest.raises(ValueError):
        knn._query_cuda(g, q, 17, 0.06)  # k above the kernel's 16
    with pytest.raises(ValueError):
        knn._query_cuda(g, q.cpu(), 8, 0.06)  # grid and queries apart
    with pytest.raises(TypeError):
        knn._query_cuda(g, q.double(), 8, 0.06)
    with pytest.raises(ValueError):  # cell_fill of the wrong type
        knn._query_cuda(g._replace(cell_fill=g.cell_fill.long()), q, 8, 0.06)
    with pytest.raises(ValueError):  # cell_fill of the wrong length
        knn._query_cuda(g._replace(cell_fill=g.cell_fill[:-1]), q, 8, 0.06)
    with pytest.raises(ValueError):  # cell_fill on another device
        knn._query_cuda(g._replace(cell_fill=g.cell_fill.cpu()), q, 8, 0.06)
    D, I, nn = knn._query_cuda(g, q[:0], 8, 0.06)  # no queries: no launch
    assert D.shape == (0, 8) and nn.shape == (0,)


def test_query_counts_the_same_on_card_and_cpu(dev):
    """Under a CostCounter a query counts ops/knn.query_cost, and only it,
    on the kernel's route and on the plain version's."""
    counts = []
    for d in (dev, torch.device("cpu")):
        g, q, r = grid_and_queries(d, 32)
        with CostCounter() as cc:
            knn.query(g, None, q, 8, r)
        counts.append((cc.flops, cc.bytes, cc.reported))
    assert counts[0] == counts[1]
    assert counts[0][2]["knn_select"][1] > 0


def test_cost_counter_sees_the_backward_on_the_card(dev):
    lin = torch.nn.Linear(64, 32).to(dev)
    x = torch.randn(256, 64, device=dev, requires_grad=True)
    with CostCounter() as cc:
        y = lin(x)
        torch.autograd.grad(y.sum(), [x, *lin.parameters()])
    assert cc.products == 3 * 2 * 256 * 64 * 32
