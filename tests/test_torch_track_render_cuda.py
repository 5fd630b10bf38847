"""The tracker's render kernels (loopy_slam_torch/csrc/track_render.cu)
against their plain version (models/track_render._render_plain) on the
card, at the benchmark cells' shapes and options: Replica (1500 rays, the
rel-pos colour transform, a scalar radius) and TUM (5000 rays, a per-query
radius). Skips without a card.

Imports neither jax nor the JAX package, so it also runs on a machine that
has neither (the repo's conftest imports jax, hence --noconftest there):

    python -m pytest --noconftest -m cuda tests/test_torch_track_render_cuda.py
"""

import copy
import ctypes

import numpy as np
import pytest
import torch

from loopy_slam_torch.config import DEFAULTS
from loopy_slam_torch.mapping import tracker
from loopy_slam_torch.models import track_render
from loopy_slam_torch.models.decoder import init_decoders
from loopy_slam_torch.models.renderer import RenderOptions
from loopy_slam_torch.ops import knn
from loopy_slam_torch.ops.draws import TorchDraws
from loopy_slam_torch.utils.cost import CostCounter
from test_torch_track_render import _scene

pytestmark = pytest.mark.cuda

# rays an iteration and the options of the benchmark's two cells
SHAPES = {"replica": dict(R=1500, rel=True, per_query=False),
          "tum": dict(R=5000, rel=False, per_query=True)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda")


def pool_inputs(dev, R, rel, per_query, seed=0, S=5, K=8, bf16=True):
    """Decoders, options and one iteration's inputs at R rays over a pool
    of 4R rows, as tracker._build_track_cache lays it out: each picked
    ray's neighbours ~1 cm around its samples, 15% of the k-NN slots empty
    (1e10), a fifth of the samples starved (nn < 2) and one ray in 50
    starved whole, one ray in ten with a zero depth's z-vals (0.3 to 10 m),
    the rest around a surface at 0.5-4 m."""
    rng = np.random.default_rng(seed)
    cfg = copy.deepcopy(DEFAULTS)
    cfg["model"]["bf16_trunks"] = bf16
    dec = init_decoders(torch.Generator(device=dev).manual_seed(seed), cfg,
                        device=dev)
    ropts = RenderOptions(n_surface=S, nn_num=K, encode_rel_pos_in_col=rel,
                          radius_query=0.08)
    C, P = ropts.c_dim, 4 * R
    pick = rng.choice(P, R, replace=False)
    surf = rng.uniform(0.5, 4.0, R)
    z = surf[:, None] * np.linspace(0.98, 1.02, S)[None, :]
    zero = rng.uniform(size=R) < 0.1
    z[zero] = np.linspace(0.3, 10.0, S)[None, :]
    dirs = rng.normal(size=(R, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts = (dirs[:, None, :] * z[..., None]).reshape(R * S, 3)
    pool_pts = rng.uniform(-2, 2, (P, S, 3))
    pool_pts[pick] = pts.reshape(R, S, 3)
    nb = pool_pts[:, :, None, :] + rng.normal(0, 0.01, (P, S, K, 3))
    feats = rng.normal(0, 0.3, (P, S, K, 2 * C))
    both = np.concatenate([feats, nb], -1).reshape(P, S * K, 2 * C + 3)
    D = np.sum((nb - pool_pts[:, :, None, :]) ** 2, -1).reshape(P, S * K)
    D[rng.uniform(size=D.shape) < 0.15] = 1e10
    nn = rng.integers(2, K + 1, (P, S))
    nn[rng.uniform(size=(P, S)) < 0.2] = 0
    nn[pick[rng.uniform(size=R) < 0.02]] = 1
    rq = rng.uniform(0.04, 0.12, P) if per_query else None

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)

    cache = {"D": f32(D), "both": f32(both),
             "nn": torch.as_tensor(nn.astype(np.int32), device=dev),
             "rq": None if rq is None else f32(rq), "d": f32(np.ones(P))}
    noise = [f32(rng.normal(size=(R * S, C))) for _ in range(2)]
    return (dec, ropts, f32(pts), f32(z), cache,
            torch.as_tensor(pick, device=dev), *noise)


def _grads(dev, R, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(R, generator=g, device=dev),
            torch.randn((R, 3), generator=g, device=dev))


def _render(fn, inputs, gd, gc):
    """(depth, var, colour, d pts) of fn on inputs, for the rays' depth and
    colour gradients gd, gc."""
    dec, ropts, pts, z, cache, pick, ng, nc = inputs
    p = pts.clone().requires_grad_(True)
    depth, var, color = fn(dec, p, z, cache, pick, ng, nc, ropts)
    (gp,) = torch.autograd.grad((depth, color), (p,), (gd, gc))
    return [t.detach() for t in (depth, var, color, gp)]


def gaps(a, b):
    """Depth, variance and colour: the largest |a - b| over b's largest;
    the points' gradient: |a - b| / |b|."""
    out = [float((x - y).abs().max() / y.abs().max())
           for x, y in zip(a[:3], b[:3])]
    return out + [float((a[3] - b[3]).norm() / b[3].norm())]


def _close(a, b, rtol):
    """|a - b| <= rtol |b| elementwise, with rtol of b's largest as the
    floor near zero."""
    return bool(torch.all((a - b).abs() <= rtol * (b.abs() + b.abs().max()
                                                  * 1e-2)))


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("cell", sorted(SHAPES))
def test_kernels_match_the_plain_version(dev, cell, bf16):
    """Depth, variance and colour within 1e-5 relative, the points'
    gradient within 1e-4 relative norm. The kernels sum in the plain
    version's order on the card (cuBLAS's sequential products, torch's
    reduction and scan orders, autograd's formulas), so that bf16
    rounding, of the trunks' inputs and of their gradients, lands where
    the plain version's does: a sum in another order moves a value across
    a rounding boundary now and then, by a bf16 step (2^-8), which put the
    points' gradient ~3e-4 apart."""
    inputs = pool_inputs(dev, **SHAPES[cell], bf16=bf16)
    gd, gc = _grads(dev, SHAPES[cell]["R"])
    d1, v1, c1, g1 = _render(track_render.render, inputs, gd, gc)
    d0, v0, c0, g0 = _render(track_render._render_plain, inputs, gd, gc)
    assert _close(d1, d0, 1e-5) and _close(v1, v0, 1e-5)
    assert _close(c1, c0, 1e-5)
    assert float((g1 - g0).norm() / g0.norm()) <= 1e-4
    assert bool(torch.isfinite(g1).all()) and float(g0.norm()) > 0


@pytest.mark.parametrize("cell", sorted(SHAPES))
def test_kernels_match_the_plain_version_off_the_cells_batch(dev, cell):
    """The single-call tolerances at 400 rays, a batch no cell runs (its
    last block of 12 rays holds 4): depth, variance and colour within 1e-5
    relative, the points' gradient within 1e-4 relative norm. Bit-equality
    is not asked here: cuBLAS may pick a kernel that sums the plain
    version's products in another order at this batch."""
    shape = {**SHAPES[cell], "R": 400}
    inputs = pool_inputs(dev, **shape, seed=5)
    gd, gc = _grads(dev, shape["R"])
    d1, v1, c1, g1 = _render(track_render.render, inputs, gd, gc)
    d0, v0, c0, g0 = _render(track_render._render_plain, inputs, gd, gc)
    assert _close(d1, d0, 1e-5) and _close(v1, v0, 1e-5)
    assert _close(c1, c0, 1e-5)
    assert float((g1 - g0).norm() / g0.norm()) <= 1e-4
    assert bool(torch.isfinite(g1).all()) and float(g0.norm()) > 0


@pytest.mark.parametrize("cell", sorted(SHAPES))
def test_forward_is_bit_equal_to_the_plain_version(dev, cell):
    """The design's claim at the cells' shapes: depth, variance and colour
    bit-equal to the plain version on the card."""
    inputs = pool_inputs(dev, **SHAPES[cell], seed=3)
    gd, gc = _grads(dev, SHAPES[cell]["R"])
    fused = _render(track_render.render, inputs, gd, gc)
    plain = _render(track_render._render_plain, inputs, gd, gc)
    for a, b in zip(fused[:3], plain[:3]):
        assert torch.equal(a, b)
    assert gaps(fused, plain)[3] <= 1e-6


@pytest.mark.parametrize("cell", sorted(SHAPES))
def test_two_calls_agree_bit_for_bit_and_count_two_launches(dev, cell):
    dec, ropts, pts, z, cache, pick, ng, nc = pool_inputs(dev,
                                                          **SHAPES[cell])
    outs = []
    for _ in range(2):
        n0 = track_render.TRACK_RENDER_LAUNCHES.count
        p = pts.clone().requires_grad_(True)
        depth, var, color = track_render.render(dec, p, z, cache, pick, ng,
                                                nc, ropts)
        loss = depth.sum() + (color * color).sum()
        (gp,) = torch.autograd.grad(loss, (p,))
        torch.cuda.synchronize()
        assert track_render.TRACK_RENDER_LAUNCHES.count == n0 + 2
        outs.append((depth, var, color, gp))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cell", sorted(SHAPES))
def test_reported_cost_is_the_plain_routes(dev, cell):
    dec, ropts, pts, z, cache, pick, ng, nc = pool_inputs(dev,
                                                          **SHAPES[cell])
    counts = []
    for fn in (track_render.render, track_render._render_plain):
        p = pts.clone().requires_grad_(True)
        with CostCounter() as cf:
            depth, var, color = fn(dec, p, z, cache, pick, ng, nc, ropts)
        grads = (torch.ones_like(depth), torch.ones_like(color))
        with CostCounter() as cb:
            torch.autograd.grad((depth, color), (p,), grads)
        counts.append([(c.flops, c.bytes, c.transcendentals, c.products)
                       for c in (cf, cb)])
    assert counts[0] == counts[1]
    assert counts[0][0][0] > 0 and counts[0][1][0] > 0


def test_kernels_reject_what_they_do_not_take(dev):
    dec, ropts, pts, z, cache, pick, ng, nc = pool_inputs(dev, 64, True,
                                                          False)
    with pytest.raises(ValueError):  # the points on another device
        track_render._TrackRender.apply(pts.cpu(), z, dec, cache, pick, ng,
                                        nc, ropts)
    with pytest.raises(ValueError):  # strided points
        track_render._TrackRender.apply(pts.t().contiguous().t(), z, dec,
                                        cache, pick, ng, nc, ropts)
    with pytest.raises(ValueError):  # int64 neighbour counts
        track_render._TrackRender.apply(
            pts, z, dec, {**cache, "nn": cache["nn"].long()}, pick, ng, nc,
            ropts)


def test_entry_points_take_at_most_31_samples_a_ray(dev):
    """The compositing scans a ray's S + 1 transmittances in 32 slots, so
    the C entry points refuse S = 32 before they touch a pointer, and take
    S = 31 (R = 0 returns before any launch)."""
    from loopy_slam_torch.csrc.build import load_track_library

    lib = load_track_library()
    one = ctypes.c_float(1.0)
    for S, rc in ((32, -1), (31, 0)):
        R = 1 if rc else 0
        assert lib.track_render_forward(
            None, None, None, None, None, None, None, None, one, None, None,
            None, None, None, None, R, S, 8, 2, 1, 1, 1, one, None) == rc
        assert lib.track_render_backward(
            None, None, None, None, None, None, None, None, one, None, 0,
            None, 0, 0, None, None, R, S, 8, 2, 1, 1, 1, one, None) == rc
    assert track_render.MAX_S == 31


def _to(dev, scene):
    dec, pos, grid, feats, color, depth, opts, ropts, rq, cam7 = scene
    return (dec.to(dev), pos.to(dev),
            knn.HashGrid(*[t.to(dev) for t in grid]), feats.to(dev),
            color.to(dev), depth.to(dev), opts, ropts,
            None if rq is None else rq.to(dev), cam7.to(dev))


@pytest.mark.parametrize("cell", sorted(SHAPES))
def test_forty_iterations_end_at_the_same_pose(dev, cell, monkeypatch):
    """_track_frame_impl, 40 iterations (warm-up blocks and pools of
    knn_refresh 10), on the fused path and on today's decode and
    compositing with the same draws, over tests/test_torch_track_render's
    wall with the cell's options and rays an iteration: the poses within
    1e-4, the same first and best losses, and the pose moved. This holds
    only at the cells' batches (1500, 5000 rays), where the kernels sum in
    the order of the kernel cuBLAS picks for the plain version; at 400
    rays cuBLAS picks another, a bf16 rounding flips now and then, and 40
    iterations ended 9e-3 apart (the single-call tolerances hold there:
    test_kernels_match_the_plain_version_off_the_cells_batch)."""
    per_query = SHAPES[cell]["per_query"]
    scene = _to(dev, _scene(rel=SHAPES[cell]["rel"], per_query=per_query,
                            H=120, W=160, pixels=SHAPES[cell]["R"],
                            iters=40))
    dec, pos, grid, feats, color, depth, opts, ropts, rq, cam7 = scene
    opts = opts._replace(knn_refresh=10, pool_factor=4)
    outs = []
    for fused in (True, False):
        with monkeypatch.context() as m:
            if not fused:
                m.setattr(tracker.track_render, "eligible",
                          lambda *a, **k: False)
            n0 = track_render.TRACK_RENDER_LAUNCHES.count
            out = tracker._track_frame_impl(
                dec, pos, grid, feats, color, depth, cam7,
                TorchDraws(11, dev), opts, ropts, r_query=rq)
            torch.cuda.synchronize()
            assert track_render.TRACK_RENDER_LAUNCHES.count - n0 == \
                (2 * opts.iters if fused else 0)
        outs.append(out)
    assert float((outs[0].cam7 - outs[1].cam7).abs().max()) <= 1e-4
    assert torch.equal(outs[0].first_loss, outs[1].first_loss)
    assert torch.equal(outs[0].best_loss, outs[1].best_loss)
    assert float(outs[1].best_loss) < float(outs[1].first_loss)
    assert float((outs[1].cam7 - cam7).abs().max()) > 1e-4
