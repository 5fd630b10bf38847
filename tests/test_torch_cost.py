"""The port's cost accounting on the CPU: utils/cost.CostCounter against
hand counts and against XLA's cost analysis of the same render step,
ops/knn.query_cost, LoopySLAM.roofline() on tiny sessions, and the CLI's
LOOPY_PROGRESS lines and eval_ate's positional config.

Counts read shapes only (the k-NN part reads the index's fill counts), so
the checks are exact except the comparison with XLA: its flops count the
same products (held exactly against the analytic count) but other
elementwise work (its random draws' threefry bits, a scatter-add's adds,
a sigmoid's backward as three ops), within 30% of the total.
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loopy_slam_torch.config import DEFAULTS as TDEFAULTS
from loopy_slam_torch.config import update_recursive
from loopy_slam_torch.convert import decoders_from_numpy
from loopy_slam_torch.mapping import tracker as ttr
from loopy_slam_torch.models import renderer as trend
from loopy_slam_torch.ops import compositing as tcomp
from loopy_slam_torch.ops import knn as tknn
from loopy_slam_torch.ops.draws import TorchDraws
from loopy_slam_torch.slam import LoopySLAM
from loopy_slam_torch.tools import eval_ate as tate
from loopy_slam_torch.utils.cost import CostCounter
from loopy_slam_tpu.config import DEFAULTS
from loopy_slam_tpu.mapping import tracker as jtr
from loopy_slam_tpu.mapping.point_cloud import MapOptions, init_map
from loopy_slam_tpu.models import decoder as jdec
from loopy_slam_tpu.models import renderer as jrend
from loopy_slam_tpu.ops import compositing as jcomp
from loopy_slam_tpu.tools import eval_ate as jate
from conftest import small_cfg
from torch_cpu import torch_cpu  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.usefixtures("torch_cpu")

# total flops of the port's count against XLA's on the same render step
XLA_FLOPS_RTOL = 0.30


# ---------------------------------------------------------------------------
# the counter against hand counts
# ---------------------------------------------------------------------------

M_, K_, N_ = 6, 5, 3


def _linear_forward():
    lin = torch.nn.Linear(K_, N_)
    x = torch.randn(M_, K_)
    with CostCounter() as cc:
        lin(x)
    prod = 2 * M_ * N_ * K_
    # addmm(bias, x, W^T): the product and the bias term; bias, x, W and
    # the output moved once
    return cc, dict(flops=prod + M_ * N_, products=prod, transcendentals=0,
                    bytes=4 * (N_ + M_ * K_ + K_ * N_ + M_ * N_))


def _linear_forward_backward():
    lin = torch.nn.Linear(K_, N_)
    x = torch.randn(M_, K_, requires_grad=True)
    with CostCounter() as cc:
        y = lin(x)
        torch.autograd.grad(y.sum(), [x, *lin.parameters()])
    # forward, grad of the input and grad of the weight: 3x the product
    return cc, dict(products=3 * 2 * M_ * N_ * K_)


def _add():
    a, b = torch.randn(100), torch.randn(100)
    with CostCounter() as cc:
        a + b
    return cc, dict(flops=100, products=0, transcendentals=0, bytes=1200)


def _exp():
    a = torch.randn(100)
    with CostCounter() as cc:
        torch.exp(a)
    return cc, dict(flops=0, transcendentals=100, bytes=800)


def _view():
    a = torch.randn(4, 25)
    with CostCounter() as cc:
        a.view(100).reshape(10, 10).expand(3, 10, 10).detach()
    return cc, dict(flops=0, transcendentals=0, bytes=0)


def _sum():
    a = torch.randn(100)
    with CostCounter() as cc:
        a.sum()
    return cc, dict(flops=100, transcendentals=0, bytes=404)


def _index_select():
    table = torch.randn(1000, 16)
    idx = torch.randint(0, 1000, (50,))
    with CostCounter() as cc:
        table.index_select(0, idx)
    # twice the output plus the indices, never the whole table
    return cc, dict(flops=0, bytes=2 * 50 * 16 * 4 + 50 * 8)


def _inplace_add():
    a, b = torch.randn(100), torch.randn(100)
    with CostCounter() as cc:
        a.add_(b)
    # the written tensor is read and written
    return cc, dict(flops=100, bytes=1200)


@pytest.mark.parametrize("case", [
    _linear_forward, _linear_forward_backward, _add, _exp, _view, _sum,
    _index_select, _inplace_add], ids=lambda f: f.__name__[1:])
def test_counter_against_hand_counts(case):
    cc, want = case()
    got = {k: getattr(cc, k) for k in want}
    assert got == want
    assert not cc.unclassified


def test_counter_pauses_and_takes_reports():
    a = torch.randn(100)
    with CostCounter() as cc:
        with cc.paused():
            a * a
        cc.add("kernel", 7, 11)
        a * a
    assert (cc.flops, cc.bytes, cc.reported) == (107, 1211,
                                                 {"kernel": [7, 11]})


# ---------------------------------------------------------------------------
# against XLA's cost analysis: decode_neighbors + composite + L1 loss
# ---------------------------------------------------------------------------

@pytest.fixture
def f32_trunks():
    jdec.set_bf16_trunks(False)
    yield
    jdec.set_bf16_trunks(True)


def _analytic_products(n, k, c):
    """2*rows*in*out of every matmul of the color-stage decode, forward."""
    g, h, ge, ce, re = (jdec.GEO_HIDDEN, jdec.COL_HIDDEN, jdec.GEO_EMB,
                        2 * jdec.COL_EMB, 2 * jdec.REL_EMB)
    geo = [(ge, g), (g, g), (g, g), (g + ge, g), (g, g)] + [(c, g)] * 5 \
        + [(g, 1)]
    col = [(ce, h), (h, h), (h, h), (h + ce, h), (h, h)] + [(c, h)] * 5 \
        + [(h, 3)]
    neigh = [(re + c, h), (h, c)]
    return 2 * (n * sum(a * b for a, b in geo + col)
                + n * k * sum(a * b for a, b in neigh))


def test_counter_against_xla_render_step(f32_trunks):
    """Forward and backward (grads of every decoder parameter and the
    features) of one color-stage render step at fixed neighbour indices:
    the port's products equal the analytic count (forward, input grads and
    weight grads: 3x the forward's), and its total flops lie within
    XLA_FLOPS_RTOL of XLA's count of JAX's step."""
    rng = np.random.default_rng(0)
    R, S, k, c, cap = 16, 5, 8, 32, 256
    n = R * S
    ropts = jrend.RenderOptions.from_cfg(DEFAULTS)
    assert (ropts.n_surface, ropts.nn_num, ropts.c_dim) == (S, k, c)
    pos = rng.uniform(-1, 1, (cap, 3)).astype(np.float32)
    feats = rng.normal(scale=0.1, size=(cap, 2 * c)).astype(np.float32)
    I = rng.integers(0, cap, (n, k)).astype(np.int32)
    D_idx = np.where(rng.random((n, k)) < 0.9, 0.01, 1e10).astype(np.float32)
    nn = rng.integers(0, k + 1, n).astype(np.int32)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    z = np.sort(rng.uniform(1, 2, (R, S)), 1).astype(np.float32)
    gd = rng.uniform(1, 2, R).astype(np.float32)
    gc = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    rq = ropts.radius_query
    params = jdec.init_decoders(jax.random.PRNGKey(1), DEFAULTS)

    def jstep(params, feats, key):
        def loss(params, feats):
            both = jrend.gather_featpos(feats, jnp.asarray(pos),
                                        jnp.asarray(I))
            occ, rgb, _ = jrend.decode_neighbors(
                params, jnp.asarray(pts), key, ropts, "color",
                jnp.asarray(D_idx), both, jnp.asarray(nn), rq)
            depth, _, color, _ = jcomp.composite(
                rgb.reshape(R, S, 3), occ.reshape(R, S), jnp.asarray(z),
                ropts.sigmoid_coef)
            return (jnp.sum(jnp.abs(depth - gd))
                    + jnp.sum(jnp.abs(color - gc)))
        return jax.value_and_grad(loss, argnums=(0, 1))(params, feats)

    ca = jax.jit(jstep).lower(params, jnp.asarray(feats),
                              jax.random.PRNGKey(2)).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    xla_flops = float(ca["flops"])

    dec = decoders_from_numpy(jax.tree.map(np.asarray, params), "cpu",
                              bf16_trunks=False)
    topts = trend.RenderOptions(**{f: getattr(ropts, f)
                                   for f in trend.RenderOptions._fields})
    tf = torch.as_tensor(feats).requires_grad_(True)
    draw = TorchDraws(2, "cpu")
    with CostCounter() as cc:
        both = trend.gather_featpos(tf, torch.as_tensor(pos),
                                    torch.as_tensor(I))
        occ, rgb, _ = trend.decode_neighbors(
            dec, torch.as_tensor(pts), draw, topts, "color",
            torch.as_tensor(D_idx), both, torch.as_tensor(nn), rq)
        depth, _, color, _ = tcomp.composite(
            rgb.reshape(R, S, 3), occ.reshape(R, S), torch.as_tensor(z),
            topts.sigmoid_coef)
        loss = (torch.sum(torch.abs(depth - torch.as_tensor(gd)))
                + torch.sum(torch.abs(color - torch.as_tensor(gc))))
        torch.autograd.grad(loss, list(dec.parameters()) + [tf],
                            allow_unused=True)
    assert not cc.unclassified
    print(f"render step: port {cc.flops} flops, XLA {xla_flops:.0f}")
    assert cc.products == 3 * _analytic_products(n, k, c)
    assert cc.flops == pytest.approx(xla_flops, rel=XLA_FLOPS_RTOL)
    assert cc.bytes > 0 and cc.transcendentals > 0


# ---------------------------------------------------------------------------
# query_cost: the k-NN kernel's work, the same on both routes
# ---------------------------------------------------------------------------

def _grid_and_queries(seed=0):
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.uniform(-0.5, 0.5, (3000, 3)).astype(
        np.float32))
    grid = tknn.build(pts, torch.arange(3000) < 2500, 0.1, 2 ** 10, 16)
    q = torch.as_tensor(rng.uniform(-0.6, 0.6, (5000, 3)).astype(np.float32))
    r = torch.as_tensor(rng.uniform(0.02, 0.1, 5000).astype(np.float32))
    return pts, grid, q, r


def test_query_cost_counts_the_filled_slots():
    pts, grid, q, _ = _grid_and_queries()
    k = 8
    h = tknn.stencil_rows(grid, q)
    fill = grid.cell_fill.long()
    rows = torch.unique(h)
    Q = q.shape[0]
    want_bytes = (int(fill[rows].sum()) * 16 + rows.numel() * 4 + Q * 12
                  + 4 + Q * (k * 8 + 4))
    want_ops = int(fill[h].sum()) * 8
    assert tknn.query_cost(grid, q, k) == (want_bytes, want_ops)
    nbytes, ops = tknn.query_cost(grid, q, k, per_query_radius=True)
    assert (nbytes, ops) == (want_bytes + 4 * Q, want_ops)
    # chip_smoke's bound reads the same count
    ms, by, b2, o2 = chip_smoke.knn_bound(grid, q, k)
    assert (b2, o2) == (want_bytes, want_ops)
    assert ms == pytest.approx(1e3 * max(
        want_bytes / chip_smoke.PEAK_BYTES_S,
        want_ops / chip_smoke.PEAK_F32_FLOPS))


@pytest.mark.parametrize("chunked", [False, True])
def test_query_reports_its_cost_and_nothing_else(chunked):
    """Under a counter a query counts query_cost once, whatever the plain
    version ran (and query_chunked's CPU chunks count as one query)."""
    pts, grid, q, r = _grid_and_queries(1)
    with CostCounter() as cc:
        if chunked:
            tknn.query_chunked(grid, pts, q, 8, r, chunk=1024)
        else:
            tknn.query(grid, pts, q, 8, r)
    nbytes, ops = tknn.query_cost(grid, q, 8, per_query_radius=True)
    assert cc.reported == {"knn_select": [ops, nbytes]}
    assert (cc.flops, cc.bytes) == (ops, nbytes)


# ---------------------------------------------------------------------------
# the tracker's count grows with its iterations (XLA's does not)
# ---------------------------------------------------------------------------

def _tiny_cfg(out, frames=3, chunk=16, **over):
    cfg = copy.deepcopy(TDEFAULTS)
    update_recursive(cfg, {
        "dataset": "synthetic", "use_dynamic_radius": False,
        "setup_seed": 1219, "verbose": False,
        "cam": {"H": 60, "W": 80, "fx": 60.0, "fy": 60.0, "cx": 39.5,
                "cy": 29.5, "png_depth_scale": 6553.5, "crop_edge": 0},
        "data": {"n_frames": frames, "output": str(out)},
        "tracking": {"pixels": 200, "iters": 4, "ignore_edge_W": 4,
                     "ignore_edge_H": 4, "vis_freq": 0},
        "mapping": {"every_frame": 2, "pixels": 400, "pixels_adding": 800,
                    "pixels_based_on_color_grad": 0, "iters": 30,
                    "iters_first": 40, "geo_iter_first": 20,
                    "mapping_window_size": 4, "keyframe_every": 2,
                    "color_refine": False, "segment_strategy": "none",
                    "device_chunk_iters": chunk, "vis_freq": 0},
        "rendering": {"sample_near_pcl": False, "eval_img": False},
        "pointcloud": {"capacity": 2 ** 15, "cell_table_size": 2 ** 16,
                       "max_per_cell": 24, "radius_add": 0.08,
                       "radius_query": 0.16, "radius_min": 0.04},
        "meshing": {"eval_rec": False},
    })
    update_recursive(cfg, over)
    return cfg


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """A tiny 3-frame session with 8-iteration chunks (frame 2 is tracked
    and mapped, each stage in full chunks and a partial one), run with
    LOOPY_PROGRESS unset; its stderr is kept as `stderr_text`, and the
    count of every mapping chunk it ran, as it ran, as `chunk_counts`."""
    import contextlib
    import io

    from torch_cpu import cpu_settings

    out = tmp_path_factory.mktemp("cost_session")
    err = io.StringIO()
    with cpu_settings(), contextlib.redirect_stderr(err):
        os.environ.pop("LOOPY_PROGRESS", None)
        slam = LoopySLAM(_tiny_cfg(out, chunk=8), device="cpu")
        _count_every_chunk(slam)
        slam.run()
        slam.close()
    slam.stderr_text = err.getvalue()
    return slam


def _count_every_chunk(slam):
    """Count each optimize_map chunk of the session as it runs, with the
    frame it belongs to, into slam.chunk_counts."""
    slam.chunk_counts = []
    frame = {}
    map_frame, optimize = slam.map_frame, slam._optimize

    def counted_map_frame(idx, *args, **kw):
        frame["idx"] = idx
        return map_frame(idx, *args, **kw)

    def counted_optimize(*args, **kw):
        with CostCounter() as cc:
            out = optimize(*args, **kw)
        n_geo, n_col = args[7], args[8]
        knn_flops, knn_bytes = cc.reported.get("knn_select", (0, 0))
        slam.chunk_counts.append(dict(
            idx=frame["idx"], n_geo=n_geo, n_col=n_col, flops=cc.flops,
            bytes=cc.bytes, transcendentals=cc.transcendentals,
            products=cc.products, knn_flops=knn_flops, knn_bytes=knn_bytes))
        return out

    slam.map_frame, slam._optimize = counted_map_frame, counted_optimize


def test_track_count_is_linear_in_iters(session):
    """Without the k-NN (its filled slots depend on each pool's pose), the
    count is set-up + blocks x pool build + iters x iteration: with one
    iteration a block (knn_refresh 1) it is linear in tracking.iters,
    exactly."""
    topts, ropts = session._roofline_calls["track"]["tail"]
    c = {}
    for it in (1, 2, 4):
        cc = session._count_call(session._roofline_calls["track"],
                                 (topts._replace(iters=it, knn_refresh=1),
                                  ropts))
        knn_flops, knn_bytes = cc.reported["knn_select"]
        c[it] = np.array([cc.flops - knn_flops, cc.bytes - knn_bytes,
                          cc.transcendentals, cc.products], np.int64)
    assert (c[4] - c[2] == 2 * (c[2] - c[1])).all()
    assert (c[2] > c[1]).all()


def test_jax_track_cost_counts_one_loop_body():
    """XLA's cost analysis of JAX's track_frame (the figure the JAX
    package's roofline() reports) counts the fori_loop's body once: the
    lowered program's count is the same at tracking.iters 1 and 4, the
    compiled program's (what roofline() reads) the same at 4 and 8 (at 1
    XLA simplifies the one-trip loop, which moves it by 0.02%)."""
    cfg = small_cfg()
    state = init_map(MapOptions.from_cfg(cfg))
    params = jdec.init_decoders(jax.random.PRNGKey(0), cfg)
    H, W = cfg["cam"]["H"], cfg["cam"]["W"]
    ropts = jrend.RenderOptions.from_cfg(
        cfg, sigmoid_coef=cfg["rendering"]["sigmoid_coef_tracker"])

    def lowered(it):
        topts = jtr.TrackOptions.from_cfg(cfg)._replace(iters=it, H=H, W=W)
        return jtr.track_frame.lower(
            params, state.pos, state.grid, state.feat, jnp.zeros((H, W, 3)),
            jnp.ones((H, W)), jnp.asarray([1.0, 0, 0, 0, 0, 0, 0]),
            jax.random.PRNGKey(1), topts, ropts)

    def compiled_cost(it):
        ca = lowered(it).compile().cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        return float(ca["flops"]), float(ca["bytes accessed"])

    pre = [float(lowered(it).cost_analysis()["flops"]) for it in (1, 4)]
    assert pre[0] == pre[1] > 0
    post = [compiled_cost(it) for it in (4, 8)]
    print(f"JAX track_frame, compiled: {post[0][0]:.0f} flops, "
          f"{post[0][1]:.0f} bytes at iters 4 and 8")
    assert post[0] == post[1] and post[0][0] > 0


# ---------------------------------------------------------------------------
# LoopySLAM.roofline() on tiny sessions
# ---------------------------------------------------------------------------

def _session_state(slam):
    s = slam.map_state
    return dict(
        est=slam.estimate_c2w.copy(), pos=s.pos.clone(),
        feat=s.feat.detach().clone(),
        dec={n: p.detach().clone() for n, p in slam.dec.named_parameters()},
        draw=slam.draw.gen.get_state().clone(),
        nprng=copy.deepcopy(slam.nprng.bit_generator.state),
        timings=copy.deepcopy(slam.timings),
        health=slam.track_health.clone(),
        launches=tknn.KNN_SELECT_LAUNCHES.count)


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for key in a:
        x, y = a[key], b[key]
        if key == "dec":
            assert all(torch.equal(x[n], y[n]) for n in x)
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), key
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, key


def test_roofline_keys_and_session_left_as_it_was(session, monkeypatch):
    calls = []
    real = tknn.query_chunked

    def spy(grid, points, queries, k, radius, **kw):
        calls.append((grid, queries, k, radius))
        return real(grid, points, queries, k, radius, **kw)

    before = _session_state(session)
    monkeypatch.setattr(tknn, "query_chunked", spy)
    rl = session.roofline()
    monkeypatch.undo()
    _assert_same(before, _session_state(session))
    assert set(rl) == {"track", "map"}
    for name in rl:
        assert {"flops", "bytes", "transcendentals", "products",
                "knn_flops", "knn_bytes", "unclassified", "idx",
                "seconds"} <= set(rl[name])
        assert rl[name]["flops"] > rl[name]["products"] > 0
        assert rl[name]["bytes"] > rl[name]["knn_bytes"] > 0
        # the counted frame is the last, timed in run()
        assert rl[name]["idx"] == 2
        assert rl[name]["seconds"] == session.timings[name][-1] > 0
    assert rl["map"]["chunk_iters"] == 8
    # the k-NN part is query_cost of the pool builds: the tracker's warm-up
    # blocks, then the geometry chunk's and the color chunk's one pool each
    topts = session.topts
    n_track = len(ttr.warmup_blocks(topts.iters, topts.knn_refresh))
    assert len(calls) == n_track + 2
    parts = ((rl["track"], calls[:n_track]),
             (rl["map"]["geo_chunk"], calls[n_track:n_track + 1]),
             (rl["map"]["col_chunk"], calls[n_track + 1:]))
    for counts, part in parts:
        cost = [tknn.query_cost(g, q, k, isinstance(r, torch.Tensor)
                                and r.dim() == 1) for g, q, k, r in part]
        assert counts["knn_bytes"] == sum(c[0] for c in cost)
        assert counts["knn_flops"] == sum(c[1] for c in cost)


# roofline()["map"] (two chunks scaled by their stages' iterations) against
# the count of every chunk of the same frame: the scaling counts a stage's
# pool build in proportion to its iterations, where the frame builds one a
# chunk, a partial chunk included
MAP_FRAME_RTOL = 0.01


def _map_against_every_chunk(slam):
    """roofline()["map"] and the chunks of its frame as they ran, after
    holding the scaled sum against their total and each kept chunk equal
    to the last full chunk of its stage."""
    rl = slam.roofline()["map"]
    chunks = [c for c in slam.chunk_counts if c["idx"] == rl["idx"]]
    C = rl["chunk_iters"]
    assert rl["n_geo"] == sum(c["n_geo"] for c in chunks) > C
    assert rl["n_col"] == sum(c["n_col"] for c in chunks) > C
    for key in ("flops", "bytes", "transcendentals", "products"):
        total = sum(c[key] for c in chunks)
        print(f"{key}: two chunks scaled {rl[key]}, every chunk {total}, "
              f"{(rl[key] - total) / total:+.4%}")
        assert abs(rl[key] - total) <= MAP_FRAME_RTOL * total, (
            key, rl[key], total)
    # each kept chunk is a full one of its stage, counted as it ran
    full = {("geo" if c["n_geo"] else "col"): c for c in chunks
            if c["n_geo"] + c["n_col"] == C}
    for stage in ("geo", "col"):
        for key in ("flops", "bytes", "products"):
            assert rl[f"{stage}_chunk"][key] == full[stage][key], (stage,
                                                                   key)
    return rl, chunks


def test_roofline_map_is_one_whole_mapped_frame(session):
    rl, chunks = _map_against_every_chunk(session)
    # the frame ran full chunks and a partial one: the scaling is at work
    assert any(c["n_geo"] + c["n_col"] < rl["chunk_iters"] for c in chunks)
    # the geometry stage runs no color decode, loss or backward
    assert rl["geo_chunk"]["flops"] < rl["col_chunk"]["flops"]
    assert rl["geo_chunk"]["products"] < rl["col_chunk"]["products"]


@pytest.fixture(scope="module")
def ba_session(tmp_path_factory):
    """A tiny 6-frame session with bundle adjustment, every frame mapped
    and a keyframe (so frame 5's window holds more than 4 keyframes and BA
    trains its poses), 16 iterations a frame (15 to 32 with the clip) in
    4-iteration chunks, each counted as it ran."""
    from torch_cpu import cpu_settings

    out = tmp_path_factory.mktemp("cost_ba_session")
    with cpu_settings():
        slam = LoopySLAM(_tiny_cfg(out, frames=6, chunk=4, mapping={
            "BA": True, "every_frame": 1, "keyframe_every": 1,
            "iters": 16}), device="cpu")
        _count_every_chunk(slam)
        slam.run()
        slam.close()
    return slam


def test_roofline_map_counts_a_bundle_adjusted_frame(ba_session):
    """On a BA frame every chunk trains the window's poses: their forward
    and backward run in each iteration, and BA's window only sets their
    learning rate (0 outside it). So the kept color chunk, which lies after
    the window, counts the same work as the chunk the window falls in, and
    the scaled frame holds to the count of every chunk as a frame without
    BA does."""
    rl, chunks = _map_against_every_chunk(ba_session)
    assert rl["idx"] in ba_session.ba_frames
    m = ba_session.cfg["mapping"]
    num = rl["n_geo"] + rl["n_col"]
    lo = num * (m["geo_iter_ratio"] + 0.2)
    # BA's window starts in the first full color chunk; the kept chunk is
    # the last full one, after it
    C = rl["chunk_iters"]
    col_starts = [rl["n_geo"] + i * C for i in range(rl["n_col"] // C)]
    assert col_starts[0] <= lo < col_starts[0] + C <= col_starts[-1]
    # every chunk builds the window's rays from the poses and runs its own
    # k-NN each iteration (no ray pool): the products are the same, the
    # k-NN's filled slots move with the poses
    full_col = [c for c in chunks if c["n_col"] == C]
    assert len(full_col) >= 2
    first, kept = full_col[0], full_col[-1]
    print("first and kept color chunk:", {k: (first[k], kept[k]) for k in (
        "flops", "knn_flops", "bytes", "knn_bytes", "products")})
    assert first["products"] == kept["products"]
    assert first["flops"] - first["knn_flops"] == (kept["flops"]
                                                   - kept["knn_flops"])


def test_roofline_map_only_after_a_full_chunk(tmp_path, capfd):
    """With 64-iteration chunks no steady mapped frame fills one (30
    iterations; frame 0 does not count), so there is no "map" entry; the
    run prints one LOOPY_PROGRESS line a frame."""
    os.environ["LOOPY_PROGRESS"] = "1"
    try:
        slam = LoopySLAM(_tiny_cfg(tmp_path, chunk=64), device="cpu")
        slam.run()
        slam.close()
    finally:
        del os.environ["LOOPY_PROGRESS"]
    err = capfd.readouterr().err
    lines = [ln for ln in err.splitlines() if ln.startswith("[frame ")]
    assert len(lines) == 3
    assert lines[0].startswith("[frame 0/3 t=")
    assert " prev_err=0.0000 pts=0 segs=0]" in lines[0]
    assert "pts=" in lines[2] and "pts=0 " not in lines[2]
    assert list(slam.roofline()) == ["track"]


def test_no_progress_lines_without_the_variable(session):
    """The module's session ran with LOOPY_PROGRESS unset."""
    assert "[frame " not in session.stderr_text


def test_roofline_is_empty_before_any_hot_call(tmp_path):
    """A one-frame session maps frame 0 only: no tracked frame, no steady
    chunk."""
    slam = LoopySLAM(_tiny_cfg(tmp_path, frames=1), device="cpu")
    slam.run()
    slam.close()
    assert slam.roofline() == {}


# ---------------------------------------------------------------------------
# eval_ate with a positional config
# ---------------------------------------------------------------------------

def test_eval_ate_accepts_a_positional_config(tmp_path, monkeypatch,
                                              capsys):
    rng = np.random.default_rng(3)
    n = 20
    t = np.cumsum(rng.normal(0, 0.05, (n, 3)), 0)
    stamps = 1000.0 + 0.033 * np.arange(n)
    gt, est = tmp_path / "gt.txt", tmp_path / "est.txt"
    for path, dt, noise in ((gt, 0.0, 0.0), (est, 0.004, 0.01)):
        with open(path, "w") as f:
            for s, a in zip(stamps + dt, t + rng.normal(0, noise, t.shape)):
                f.write(" ".join(f"{x:.6f}" for x in (s, *a, 0, 0, 0, 1))
                        + "\n")
    files = ["--est_traj", str(est), "--gt_traj", str(gt)]
    cfg = os.path.join(ROOT, "configs", "Synthetic", "room.yaml")
    with_cfg = tate.main([cfg] + files)
    assert with_cfg == tate.main(files)
    assert with_cfg["rmse"] == jate.evaluate_tum_files(str(est),
                                                      str(gt))["rmse"]
    # the same command line through the JAX tool
    monkeypatch.setattr(sys, "argv", ["eval_ate", cfg] + files)
    capsys.readouterr()
    jate.main()
    assert "absolute_translational_error.rmse" in capsys.readouterr().out
