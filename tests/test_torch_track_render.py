"""The tracker's render step (models/track_render.py) on the CPU: which
iterations take it, and its plain version against the decode and
compositing it stands in for.

On the CPU `track_render.render` runs its plain version; the kernels it
launches on the card are held to that version by
tests/test_torch_track_render_cuda.py. Here: the choice of path by the
options alone, the tracking loss and the pose gradient bit-equal to the
iteration as it was written before (decode_neighbors draws its noise
itself), with the options of both benchmark cells (Replica: the rel-pos
colour transform and a scalar radius; TUM: neither, a per-query radius);
the same draws in the same order; the pool's keys; the `fused` attribute
of the `track.fwd` span; the cost the kernels report.
"""

import copy
import math

import numpy as np
import pytest
import torch

from loopy_slam_torch.config import DEFAULTS
from loopy_slam_torch.mapping import tracker
from loopy_slam_torch.models import track_render
from loopy_slam_torch.models.decoder import init_decoders
from loopy_slam_torch.models.renderer import RenderOptions, decode_neighbors
from loopy_slam_torch.ops import knn
from loopy_slam_torch.ops.camera import c2w_from_tensor, rays_from_uv
from loopy_slam_torch.ops.compositing import composite
from loopy_slam_torch.ops.draws import ReplayDraws, TorchDraws
from loopy_slam_torch.utils import cost, telemetry
from torch_cpu import torch_cpu  # noqa: F401  (fixture)

H, W, F = 24, 32, 30.0
# the two cells' options: Replica (rel-pos, scalar radius), TUM (per-query)
CELLS = {"replica": dict(rel=True, per_query=False),
         "tum": dict(rel=False, per_query=True)}


def _scene(rel, per_query, seed=0, bf16=True, H=H, W=W, pixels=48, iters=3,
           **ropt):
    """A small map of a slanted wall seen by the identity pose, its depth
    and colour, decoders, options, and the query-radius map (on the CPU;
    tests/test_torch_track_render_cuda.py moves it to the card)."""
    rng = np.random.default_rng(seed)
    cfg = copy.deepcopy(DEFAULTS)
    cfg["model"]["bf16_trunks"] = bf16
    dec = init_decoders(torch.Generator().manual_seed(seed), cfg,
                        device="cpu")
    jj, ii = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    depth = (1.2 + 0.02 * ii + 0.01 * jj).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0  # holes: zero depth
    cam = torch.tensor([1.0, 0, 0, 0, 0, 0, 0])
    c2w = c2w_from_tensor(cam)
    o, d = rays_from_uv(torch.as_tensor(ii.ravel()), torch.as_tensor(
        jj.ravel()), c2w, F, F, W / 2 - 0.5, H / 2 - 0.5)
    surf = o + d * torch.as_tensor(depth.ravel())[:, None]
    keep = torch.as_tensor(depth.ravel() > 0) & torch.as_tensor(
        rng.uniform(size=H * W) < 0.7)  # some rays find no neighbours
    pos = (surf[keep] + torch.as_tensor(
        rng.normal(0, 0.01, (int(keep.sum()), 3)).astype(np.float32)))
    valid = torch.ones(pos.shape[0], dtype=torch.bool)
    grid = knn.build(pos, valid, 0.16, 2 ** 12, 32)
    feats = torch.as_tensor(
        rng.normal(0, 0.3, (pos.shape[0], 64)).astype(np.float32))
    color = torch.as_tensor(rng.uniform(size=(H, W, 3)).astype(np.float32))
    opts = tracker.TrackOptions(
        pixels=pixels, iters=iters, ignore_edge_W=2, ignore_edge_H=2, H=H, W=W,
        fx=F, fy=F, cx=W / 2 - 0.5, cy=H / 2 - 0.5, knn_refresh=2,
        pool_factor=2)
    ropts = RenderOptions(encode_rel_pos_in_col=rel, radius_query=0.08,
                          **ropt)
    rq = (torch.as_tensor(rng.uniform(0.04, 0.12, (H, W)).astype(
        np.float32)) if per_query else None)
    cam7 = torch.tensor([0.999, 0.02, -0.01, 0.03, 0.01, -0.02, 0.02])
    return dec, pos, grid, feats, color, torch.as_tensor(depth), opts, \
        ropts, rq, cam7


def _loss_as_before(cam7, dec, cache, draw, opts, ropts):
    """The cached iteration as it was written before the render step became
    a Function: decode_neighbors draws its own noise."""
    c2w = c2w_from_tensor(cam7)
    S, k = ropts.n_surface, ropts.nn_num
    R = opts.pixels
    P = cache["d"].shape[0]
    pick = draw.randint((R,), 0, P)

    def take(a):
        return a.index_select(0, pick)

    d, c, inside, z = (take(cache["d"]), take(cache["c"]),
                       take(cache["inside"]), take(cache["z"]))
    D_idx = take(cache["D"]).reshape(R * S, k)
    both = take(cache["both"]).reshape(R * S, k, -1)
    nn = take(cache["nn"]).reshape(R * S)
    rays_o, rays_d = rays_from_uv(take(cache["i"]), take(cache["j"]), c2w,
                                  opts.fx, opts.fy, opts.cx, opts.cy)
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
           ).reshape(-1, 3)
    rq = (ropts.radius_query if cache["rq"] is None
          else torch.repeat_interleave(take(cache["rq"]), S))
    occ, rgb, _has = decode_neighbors(dec, pts, draw, ropts, "color", D_idx,
                                      both, nn, rq)
    depth, var, color, _ = composite(
        rgb.reshape(R, S, 3), occ.reshape(R, S), z, ropts.sigmoid_coef)
    depth = torch.where(d > 0, depth, torch.zeros((), device=d.device))
    return tracker._loss_from_render(d, c, inside, depth, var, color, opts)


def _cache(scene, seed=1):
    dec, pos, grid, feats, color, depth, opts, ropts, rq, cam7 = scene
    return tracker._build_track_cache(
        cam7, pos, grid, feats, color, depth, TorchDraws(seed, "cpu"), opts,
        ropts, r_query=rq)


class _Recording:
    """A TorchDraws that notes each request's kind and shape."""

    def __init__(self, seed):
        self.inner = TorchDraws(seed, "cpu")
        self.calls = []

    def randint(self, shape, lo, hi):
        self.calls.append(("randint", tuple(shape), lo, hi))
        return self.inner.randint(shape, lo, hi)

    def normal(self, shape):
        self.calls.append(("normal", tuple(shape)))
        return self.inner.normal(shape)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_loss_and_pose_gradient_bit_equal_to_before(torch_cpu, cell, bf16):
    scene = _scene(**CELLS[cell], bf16=bf16)
    dec, ropts, cam7 = scene[0], scene[7], scene[9]
    cache = _cache(scene)
    assert track_render.eligible(ropts)
    outs = []
    for fn in (tracker.tracking_loss_cached, _loss_as_before):
        c7 = cam7.clone().requires_grad_(True)
        loss, aux = fn(c7, dec, cache, TorchDraws(7, "cpu"), scene[6],
                       ropts)
        (g,) = torch.autograd.grad(loss, (c7,))
        outs.append((loss.detach(), g, aux[2]))
    (l1, g1, n1), (l0, g0, n0) = outs
    assert int(n0) > 10 and float(l0) > 0 and float(g0.norm()) > 0
    assert torch.equal(l1, l0) and torch.equal(n1, n0)
    assert torch.equal(g1, g0)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_same_draws_in_the_same_order(torch_cpu, cell):
    """The pool pick (R,), the geometry noise (R*S, c), the colour noise
    (R*S, c); replayed, the fused path gives the iteration's loss."""
    scene = _scene(**CELLS[cell])
    dec, opts, ropts, cam7 = scene[0], scene[6], scene[7], scene[9]
    cache = _cache(scene)
    calls, losses = [], []
    for fn in (tracker.tracking_loss_cached, _loss_as_before):
        rec = _Recording(3)
        losses.append(fn(cam7, dec, cache, rec, opts, ropts)[0])
        calls.append(rec.calls)
    n = opts.pixels * ropts.n_surface
    P = cache["d"].shape[0]
    assert calls[0] == calls[1] == [("randint", (opts.pixels,), 0, P),
                                    ("normal", (n, ropts.c_dim)),
                                    ("normal", (n, ropts.c_dim))]
    rng = np.random.default_rng(5)
    draws = [rng.integers(0, P, opts.pixels),
             rng.normal(size=(n, ropts.c_dim)),
             rng.normal(size=(n, ropts.c_dim))]
    replayed = [fn(cam7, dec, cache, ReplayDraws(list(draws), "cpu"), opts,
                   ropts)[0]
                for fn in (tracker.tracking_loss_cached, _loss_as_before)]
    assert torch.equal(replayed[0], replayed[1])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_pool_keeps_its_keys(torch_cpu, cell):
    scene = _scene(**CELLS[cell])
    cache = _cache(scene)
    assert set(cache) == {"i", "j", "d", "c", "inside", "z", "rq", "D",
                          "both", "nn"}
    assert (cache["rq"] is None) == (not CELLS[cell]["per_query"])


@pytest.mark.parametrize("change, fused", [
    ({}, True),
    ({"use_view_direction": True}, False),
    ({"encode_exposure": True}, False),
    ({"weighting": "expo"}, False),
    ({"c_dim": 16}, False),
    ({"nn_num": 17}, False),
    ({"n_surface": 65}, False),
    ({"n_surface": 32}, False),
    ({"n_surface": 31}, True),
    ({"encode_rel_pos_in_col": False}, True),
    ({"radius_query": 0.5}, True),
])
def test_eligible_on_options_alone(change, fused):
    ropts = RenderOptions()._replace(**change)
    assert track_render.eligible(ropts) is fused
    assert not track_render.eligible(RenderOptions(), exposure=(1, 2))


def _spans(scene, **frame_kw):
    """The `fused` attribute of each `track.fwd` span of one tracked
    frame."""
    dec, pos, grid, feats, color, depth, opts, ropts, rq, cam7 = scene
    tr = telemetry.Timers()
    tr.enable()
    with telemetry.active(tr):
        tracker._track_frame_impl(dec, pos, grid, feats, color, depth, cam7,
                                  TorchDraws(2, "cpu"), **frame_kw)
    return [s["attrs"]["fused"] for s in tr.spans if s["name"] == "track.fwd"]


@pytest.mark.parametrize("path", ["cached", "uncached", "near_pcl",
                                  "view_direction"])
def test_track_fwd_span_says_which_path(torch_cpu, path):
    """fused = 1 on the cached path with eligible options, else 0 (the
    uncached path, sample_near_pcl, view directions)."""
    scene = _scene(**CELLS["replica"])
    opts, ropts = scene[6], scene[7]
    if path == "uncached":
        opts = opts._replace(knn_refresh=0)
    elif path == "near_pcl":
        ropts = ropts._replace(sample_near_pcl=True)
    elif path == "view_direction":
        cfg = copy.deepcopy(DEFAULTS)
        cfg["use_view_direction"] = True
        scene = (init_decoders(torch.Generator().manual_seed(0), cfg,
                               device="cpu"),) + scene[1:]
        ropts = ropts._replace(use_view_direction=True)
    fused = _spans(scene, opts=opts, ropts=ropts)
    assert len(fused) == opts.iters
    assert fused == [int(path == "cached")] * opts.iters


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_reported_cost_is_the_plain_routes(torch_cpu, cell):
    """_cost_of_plain, what the kernels report on the card, equals a
    counter's count of the plain route at the same shapes, forward and
    backward to the points; under a counter the CPU route counts that."""
    scene = _scene(**CELLS[cell])
    dec, opts, ropts, cam7 = scene[0], scene[6], scene[7], scene[9]
    cache = _cache(scene)
    R, S, c = opts.pixels, ropts.n_surface, ropts.c_dim
    g = torch.Generator().manual_seed(4)
    pick = torch.randint(0, cache["d"].shape[0], (R,), generator=g)
    z = cache["z"].index_select(0, pick)
    pts = torch.randn((R * S, 3), generator=g).requires_grad_(True)
    ng, nc = torch.randn((R * S, c), generator=g), torch.randn(
        (R * S, c), generator=g)
    track_render._plain_cost.clear()
    with cost.CostCounter() as outer:
        fwd, bwd = track_render._cost_of_plain(dec, pts, z, cache, pick, ng,
                                               nc, ropts)
    assert outer.flops == outer.bytes == 0  # the caller's counter paused
    with cost.CostCounter() as cf:
        depth, _var, color = track_render.render(dec, pts, z, cache, pick,
                                                 ng, nc, ropts)
    grads = (torch.ones_like(depth), torch.ones_like(color))
    with cost.CostCounter() as cb:
        torch.autograd.grad((depth, color), (pts,), grads)
    assert fwd == (cf.flops, cf.bytes, cf.transcendentals, cf.products)
    assert bwd == (cb.flops, cb.bytes, cb.transcendentals, cb.products)
    assert fwd[0] > 0 and bwd[0] > 0 and fwd[3] > 0
    assert len(track_render._plain_cost) == 1


def test_cost_report_adds_transcendentals_and_products():
    with cost.CostCounter() as cc:
        cost.report("kernel", 10, 20, 3, 4)
        cost.report("kernel", 1, 2)
    assert (cc.flops, cc.bytes, cc.transcendentals, cc.products) == \
        (11, 22, 3, 4)
    assert cc.reported["kernel"] == [11, 22]


def test_weight_order_matches_the_kernels_shapes():
    """_weights lists the parameters the kernels index (W_* in
    csrc/track_render.cu) at the shapes they read them at."""
    dec = init_decoders(torch.Generator().manual_seed(0),
                        copy.deepcopy(DEFAULTS), device="cpu")
    ws = track_render._weights(dec)
    assert len(ws) == 51
    assert [tuple(w.shape) for w in ws] == track_render._SHAPES
    named = dict(dec.named_parameters())
    assert ws[0] is named["geo.B"] and ws[24] is named["col.B_rel"]
    assert ws[47] is named["col.neigh.w1"] and ws[50] is named["col.neigh.b2"]
    assert math.prod(ws[21].shape) == 32  # the geometry head
