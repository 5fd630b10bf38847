"""The CUDA k-NN kernel (loopy_slam_torch/csrc/knn_select.cu) against its
plain PyTorch version, on the card. Skips without one.

Imports neither jax nor the JAX package, so it also runs on a machine that
has neither (the repo's conftest imports jax, hence --noconftest there):

    python -m pytest --noconftest -m cuda tests/test_torch_knn_cuda.py
"""

import numpy as np
import pytest
import torch

from loopy_slam_torch.ops import knn

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


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("per_query_radius", [False, True])
@pytest.mark.parametrize("M", [16, 32, 128])
def test_kernel_bit_equal_to_plain(dev, M, per_query_radius, k):
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
    D, I, nn = knn._query_cuda(g, q[:0], 8, 0.06)  # no queries: no launch
    assert D.shape == (0, 8) and nn.shape == (0,)
