"""The port's insertion, tracking and mapping against the JAX package on
the same JAX-built map, on the CPU, with JAX's random draws replayed into
the port (ops/draws.ReplayDraws) and f32 trunks on both sides.

Tolerances:
  * insertion: the same gate, count and hash-grid fill; positions within
    1e-6; features within 1 ulp (XLA folds the 0.1 feature scale into the
    normal sampler's own constant, so 0.1 * draw rounds differently);
  * a tracked frame: first loss within 1e-4 relative; final pose within
    2e-4 per 7-vector component. Twelve Adam steps on f32 gradients that
    differ in the last bits (matmul/reduction order, Fourier phases);
    Adam's normalised step keeps such differences near the 1e-5 level per
    step.
  * a mapping chunk (3 geometry + 1 color iterations): loss terms within
    1e-3 relative; features and decoder weights within 1e-4 absolute on
    all but 0.5% of entries, and no entry further apart than both sides'
    summed learning-rate steps. Adam's normalised step turns any sign
    difference of a near-zero gradient into a full lr-sized step on one
    side only (one color step flips 0.1% of a trunk layer's entries);
    near-zero gradients come from last-bit differences of sample
    positions (a neighbour crossing the radius boundary) and from
    index_add_ summing a row's gradients in another order than XLA;
  * the geometry Fourier embedder geo.B (3 x 93 entries up to |64|) at a
    chunk's first iteration, before Adam, over keys 0-7: the port's
    gradient within GEO_B_GRAD_RATIO of the port's own float32-vs-float64
    gap on the same draws, and within GEO_B_GRAD_ATOL of JAX's. The ratio
    is tight only at the keys where no ReLU flips between float32 and
    float64 (0-3 and 5: a float32-vs-float64 gap of 7.7e-7 to 1.4e-6, so
    a bound of 3.9e-7 to 6.8e-7); at keys 4, 6 and 7 that gap is the
    flip's own jump, so there the absolute bound holds the gradient.
    Measured: port vs JAX 5.9e-8 to 1.1e-7, the
    float32-vs-float64 gap 7.6e-7 to 8.4e-4 in each package (at most 0.14
    of it); no entry's sign differs. After the chunk, 0-42% of geo.B's
    entries lie beyond 1e-4 of JAX's by key: a pre-activation of the
    geometry trunk's ReLU within rounding of zero takes another sign in
    one float32 run than in the other (one unit at keys 4, 6 and 7 between
    float32 and float64; a jump of 2e-4 to 8e-4 in geo.B's gradient), and
    Adam's normalised step turns the jump into steps of up to the learning
    rate on the entries whose gradient is of that size. Each package's
    float32 chunk lies as far from the float64 chunk (0-58% of entries
    beyond 1e-4), so the 99.5% rule holds geo.B at key 4 (0.36%) only by
    its seed; the gradient bound holds it at every key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import small_cfg
from loopy_slam_torch.convert import decoders_from_numpy, map_state_from_numpy
from loopy_slam_torch.mapping import mapper as tmapper
from loopy_slam_torch.mapping import point_cloud as tpc
from loopy_slam_torch.mapping import tracker as ttracker
from loopy_slam_torch.models.decoder import trainable_mask as t_mask
from loopy_slam_torch.models.renderer import RenderOptions as TRenderOptions
from loopy_slam_torch.ops.draws import ReplayDraws
from loopy_slam_tpu.mapping import mapper as jmapper
from loopy_slam_tpu.mapping import point_cloud as jpc
from loopy_slam_tpu.mapping import tracker as jtracker
from loopy_slam_tpu.models import decoder as jdec
from loopy_slam_tpu.models.renderer import RenderOptions
from loopy_slam_tpu.ops import adam as jadam
from loopy_slam_tpu.ops.camera import tensor_from_c2w
from loopy_slam_tpu.utils.datasets import Synthetic
from torch_cpu import torch_cpu  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_cpu")


def t(a):
    return torch.as_tensor(np.array(a))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def port_render_options(ropts):
    """The port's RenderOptions from JAX's (the port has no table fields:
    its k-NN reads the table's shape from the grid)."""
    return TRenderOptions(**{f: getattr(ropts, f)
                             for f in TRenderOptions._fields})


def leaves_with_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in leaves_with_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_names(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def convert_state(s):
    g = s.grid
    return map_state_from_numpy(
        np.asarray(s.pos), np.asarray(s.feat), np.asarray(s.count),
        np.asarray(g.cell_data), np.asarray(g.cell_fill),
        np.asarray(g.cell_size), np.asarray(g.n_dropped),
        in_pos=np.asarray(s.in_pos), in_rgb=np.asarray(s.in_rgb),
        in_count=np.asarray(s.in_count), device="cpu")


@pytest.fixture(scope="module")
def scene():
    """A JAX map of frame 0 after a short JAX mapping run, f32 trunks."""
    jdec.set_bf16_trunks(False)
    cfg = small_cfg()
    cfg["model"]["bf16_trunks"] = False
    ds = Synthetic(cfg)
    _, color, depth, c2w = ds[0]
    mopts_map = jpc.MapOptions.from_cfg(cfg)
    mopts = jmapper.MapperOptions.from_cfg(cfg)
    ropts = RenderOptions.from_cfg(cfg)
    state = jpc.init_map(mopts_map)
    params = jdec.init_decoders(jax.random.PRNGKey(0), cfg)
    state, _ = jmapper.add_points_from_frame(
        state, jnp.asarray(color), jnp.asarray(depth), jnp.asarray(c2w),
        jnp.asarray(c2w), jax.random.PRNGKey(1), mopts_map, mopts, 2000,
        overlap=None)
    trainable = {"dec": params, "feat": state.feat}
    trainable, _, _ = jmapper.optimize_map(
        trainable, jadam.init(trainable), jdec.trainable_mask(params, cfg),
        jpc.valid_mask(state), state.pos, state.grid, jnp.asarray(color)[None],
        jnp.asarray(depth)[None], jnp.asarray(c2w)[None], None,
        jax.random.PRNGKey(2), jnp.asarray(20), jnp.asarray(20),
        jnp.asarray([0.001, 0.03, 0.0]), jnp.asarray([0.005, 0.005, 0.005]),
        mopts, ropts, 300, False)
    state = state._replace(feat=trainable["feat"])
    yield dict(cfg=cfg, ds=ds, state=state, params=trainable["dec"],
               mopts_map=mopts_map, mopts=mopts, ropts=ropts)
    jdec.set_bf16_trunks(True)


def test_add_points_on_converted_map(scene):
    cfg, ds = scene["cfg"], scene["ds"]
    _, color, depth, c2w = ds[2]
    prev = ds[0][3]
    mopts_map, mopts = scene["mopts_map"], scene["mopts"]
    key = jax.random.PRNGKey(7)
    ks, ka = jax.random.split(key)
    kh, kw = jax.random.split(ks)
    n = 1500
    draws = [np.asarray(jax.random.randint(kh, (n,), 0, mopts.H)),
             np.asarray(jax.random.randint(kw, (n,), 0, mopts.W)),
             np.asarray(jax.random.normal(ka, (n * mopts_map.N_add,
                                               2 * mopts_map.c_dim)))]
    js, jn = jmapper.add_points_from_frame(
        scene["state"], jnp.asarray(color), jnp.asarray(depth),
        jnp.asarray(c2w), jnp.asarray(prev), key, mopts_map, mopts, n,
        overlap=False)
    ts, tn = tmapper.add_points_from_frame(
        convert_state(scene["state"]), t(color), t(depth), t(c2w), t(prev),
        ReplayDraws(draws, "cpu"), tpc.MapOptions(**mopts_map._asdict()),
        tmapper.MapperOptions(**{k: v for k, v in mopts._asdict().items()
                                 if k in tmapper.MapperOptions._fields}),
        n, overlap=False)
    assert int(tn) == int(jn) > 0
    assert int(ts.count) == int(js.count)
    assert int(ts.in_count) == int(js.in_count)
    cnt = int(js.count)
    np.testing.assert_allclose(ts.pos[:cnt].numpy(), np.asarray(js.pos)[:cnt],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.feat.numpy(), np.asarray(js.feat),
                               rtol=2.5e-7, atol=0)
    np.testing.assert_array_equal(ts.grid.cell_fill.numpy(),
                                  np.asarray(js.grid.cell_fill))
    assert int(ts.grid.n_dropped) == int(js.grid.n_dropped)
    # the frustum mask and the (numpy) keyframe selection agree too
    jm = jmapper.frustum_feature_mask(js.pos, js.count, jnp.asarray(c2w),
                                      jnp.asarray(depth), mopts)
    tm = tmapper.frustum_feature_mask(ts.pos, ts.count, t(c2w), t(depth),
                                      mopts)
    assert (tm.numpy() != np.asarray(jm)).sum() <= 2
    poses = [ds[i][3] for i in (0, 1, 2)]
    assert tmapper.keyframe_selection_overlap(
        np.random.default_rng(3), depth, c2w, poses, 2, mopts) == \
        jmapper.keyframe_selection_overlap(
            np.random.default_rng(3), depth, c2w, poses, 2, mopts)


def tracker_draws(key, lengths, P, R, S, c, H0, H1, W0, W1):
    """JAX's draws inside _track_frame_impl's cached path, in the port's
    order (see loopy_slam_torch/mapping/tracker.py)."""
    out = []
    k = key
    for blk in lengths:
        k, kblk = jax.random.split(k)
        kh, kw = jax.random.split(kblk)
        out += [jax.random.randint(kh, (P,), H0, H1),
                jax.random.randint(kw, (P,), W0, W1)]
        for _ in range(blk):
            k, kiter = jax.random.split(k)
            kpick, kdec = jax.random.split(kiter)
            kg, kc = jax.random.split(kdec)
            out += [jax.random.randint(kpick, (R,), 0, P),
                    jax.random.normal(kg, (R * S, c)),
                    jax.random.normal(kc, (R * S, c))]
    return [np.asarray(a) for a in out]


def test_track_one_frame_matches(scene):
    cfg, ds = scene["cfg"], scene["ds"]
    cfg = {**cfg, "tracking": {**cfg["tracking"], "pixels": 120,
                               "iters": 12, "pool_factor": 4,
                               "knn_refresh": 10}}
    topts = jtracker.TrackOptions.from_cfg(cfg)
    ropts = RenderOptions.from_cfg(
        cfg, sigmoid_coef=cfg["rendering"]["sigmoid_coef_tracker"])
    _, color, depth, c2w = ds[2]
    init = c2w.copy()
    init[:3, 3] += np.array([0.01, -0.008, 0.006], np.float32)
    cam7 = tensor_from_c2w(init)
    key = jax.random.PRNGKey(9)
    s = scene["state"]
    jout = jtracker.track_frame(
        scene["params"], s.pos, s.grid, s.feat, jnp.asarray(color),
        jnp.asarray(depth), jnp.asarray(cam7), key, topts, ropts,
        health=jnp.zeros(3))
    lengths = ttracker.warmup_blocks(topts.iters, topts.knn_refresh)
    draws = tracker_draws(
        key, lengths, topts.pixels * topts.pool_factor, topts.pixels,
        ropts.n_surface, ropts.c_dim, topts.ignore_edge_H,
        topts.H - topts.ignore_edge_H, topts.ignore_edge_W,
        topts.W - topts.ignore_edge_W)
    ts = convert_state(s)
    dec = decoders_from_numpy(to_np(scene["params"]), "cpu", bf16_trunks=False)
    tout = ttracker.track_frame(
        dec, ts.pos, ts.grid, ts.feat, t(color), t(depth), t(cam7),
        ReplayDraws(draws, "cpu"), ttracker.TrackOptions(
            **{k: v for k, v in topts._asdict().items()
               if k in ttracker.TrackOptions._fields}),
        port_render_options(ropts), health=torch.zeros(3))
    j_cam, _, j_first, j_best = (np.asarray(a) for a in jout[:4])
    t_cam, _, t_first, t_best = (a.detach().numpy() for a in tout[:4])
    np.testing.assert_allclose(t_first, j_first, rtol=1e-4)
    np.testing.assert_allclose(t_best, j_best, rtol=1e-3)
    np.testing.assert_allclose(t_cam, j_cam, atol=2e-4)
    # the optimization moved the pose (the test is not vacuous)
    assert np.abs(j_cam - cam7).max() > 1e-3
    np.testing.assert_allclose(tout[4].numpy(), np.asarray(jout[6]),
                               rtol=1e-3)


def mapper_draws(key, F, P, ppf, S, c, H, W, n_geo, n_col):
    """JAX's draws inside _optimize_map_impl's pooled path, in the port's
    order (see loopy_slam_torch/mapping/mapper.py)."""
    kpool, k = jax.random.split(key)
    out = []
    fkeys = jax.random.split(kpool, F)
    js, is_ = [], []
    for f in range(F):
        kh, kw = jax.random.split(fkeys[f])
        js.append(jax.random.randint(kh, (P,), 0, H))
        is_.append(jax.random.randint(kw, (P,), 0, W))
    out += [jnp.stack(js), jnp.stack(is_)]
    for it in range(n_geo + n_col):
        k, kiter = jax.random.split(k)
        kd, kr = jax.random.split(kiter)
        kg, kc = jax.random.split(kr)
        out += [jax.random.randint(kd, (F, ppf), 0, P),
                jax.random.normal(kg, (F * ppf * S, c))]
        if it >= n_geo:
            out.append(jax.random.normal(kc, (F * ppf * S, c)))
    return [np.asarray(a) for a in out]


def test_mapping_chunk_matches(scene):
    cfg, ds = scene["cfg"], scene["ds"]
    mopts, ropts = scene["mopts"], scene["ropts"]
    frames = [ds[i] for i in (0, 2)]
    kc = np.stack([f[1] for f in frames])
    kd = np.stack([f[2] for f in frames])
    kp = np.stack([f[3] for f in frames])
    s = scene["state"]
    params = scene["params"]
    feat_mask = np.asarray(jmapper.frustum_feature_mask(
        s.pos, s.count, jnp.asarray(kp[-1]), jnp.asarray(kd[-1]), mopts))
    ppf, n_geo, n_col = 60, 3, 1
    lrs_geo, lrs_col = [0.001, 0.03, 0.0], [0.005, 0.005, 0.005]
    key = jax.random.PRNGKey(4)
    # optimize_map donates its trainable tree: hand it copies
    trainable = jax.tree.map(jnp.copy, {"dec": params, "feat": s.feat})
    jt, _, jaux = jmapper.optimize_map(
        trainable, jadam.init(trainable), jdec.trainable_mask(params, cfg),
        jnp.asarray(feat_mask), s.pos, s.grid, jnp.asarray(kc),
        jnp.asarray(kd), jnp.asarray(kp), None, key, jnp.asarray(n_geo),
        jnp.asarray(n_col), jnp.asarray(lrs_geo), jnp.asarray(lrs_col),
        mopts, ropts, ppf, False)
    draws = mapper_draws(key, 2, mopts.pixel_pool_factor * ppf, ppf,
                         ropts.n_surface, ropts.c_dim, mopts.H, mopts.W,
                         n_geo, n_col)
    ts = convert_state(s)
    dec = decoders_from_numpy(to_np(params), "cpu", bf16_trunks=False)
    feat, _, taux = tmapper.optimize_map(
        dec, ts.feat, None, t_mask(dec, cfg), t(feat_mask), ts.pos, ts.grid,
        t(kc), t(kd), t(kp), ReplayDraws(draws, "cpu"), n_geo, n_col, lrs_geo,
        lrs_col, tmapper.MapperOptions(
            **{k: v for k, v in mopts._asdict().items()
               if k in tmapper.MapperOptions._fields}),
        port_render_options(ropts), ppf)
    ja = [float(a) for a in jaux]
    ta = [float(a) for a in taux]
    assert ta[2] == ja[2] > 0
    np.testing.assert_allclose(ta[:2], ja[:2], rtol=1e-3)
    jp = dict(leaves_with_names(to_np(jt["dec"])))
    pairs = [(feat.numpy(), np.asarray(jt["feat"]),
              n_geo * lrs_geo[1] + n_col * lrs_col[1])]
    pairs += [(p.detach().numpy(), jp[n], n_geo * lrs_geo[0]
               + n_col * lrs_col[0]) for n, p in dec.named_parameters()]
    for a, b, lr_sum in pairs:
        diff = np.abs(a - b)
        assert np.mean(diff > 1e-4) < 0.005
        assert diff.max() <= 2 * lr_sum + 1e-6
    moved = np.abs(np.asarray(jt["feat"]) - np.asarray(s.feat)).max()
    assert moved > 1e-3


# the port-vs-JAX gap of geo.B's first gradient over the port's own
# float32-vs-float64 gap (measured at most 0.14 over keys 0-7), and the
# gap itself (measured 5.9e-8 to 1.1e-7 against a gradient above 1e-2)
GEO_B_GRAD_RATIO = 0.5
GEO_B_GRAD_ATOL = 1e-6


def _first_geo_B_grads(scene, key):
    """geo.B's gradient at a chunk's first geometry iteration (the pool
    build, then one iteration's draws), before any Adam step: JAX's, the
    port's on JAX's draws, and the port's in float64 on the same draws and
    pool (decoders, features and the pool's floats cast)."""
    cfg, ds = scene["cfg"], scene["ds"]
    mopts, ropts = scene["mopts"], scene["ropts"]
    frames = [ds[i] for i in (0, 2)]
    kc, kd, kp = (np.stack([f[i] for f in frames]) for i in (1, 2, 3))
    s, params = scene["state"], scene["params"]
    ppf = 60
    P = mopts.pixel_pool_factor * ppf
    kpool, k = jax.random.split(key)
    pool = jmapper._build_pool(s.pos, s.grid, jnp.asarray(kc),
                               jnp.asarray(kd), jnp.asarray(kp), None, kpool,
                               mopts, ropts, P)
    _, kiter = jax.random.split(k)
    _, g = jax.value_and_grad(jmapper._map_loss_pool, has_aux=True)(
        {"dec": params, "feat": s.feat}, pool, s.pos, kiter, "geometry",
        mopts, ropts, ppf, None)
    out = [np.asarray(g["dec"]["geo"]["B"], np.float64)]
    topts = tmapper.MapperOptions(
        **{k: v for k, v in mopts._asdict().items()
           if k in tmapper.MapperOptions._fields})
    tropts = port_render_options(ropts)
    ts = convert_state(s)
    for f64 in (False, True):
        draw = ReplayDraws(mapper_draws(key, 2, P, ppf, ropts.n_surface,
                                        ropts.c_dim, mopts.H, mopts.W, 1, 0),
                           "cpu")
        dec = decoders_from_numpy(to_np(params), "cpu", bf16_trunks=False)
        tpool = tmapper._build_pool(ts.pos, ts.grid, t(kc), t(kd), t(kp),
                                    None, draw, topts, tropts, P)
        feat = ts.feat
        if f64:
            dec, feat = dec.double(), feat.double()
            tpool = tpool._replace(**{
                f: v.double() for f, v in tpool._asdict().items()
                if isinstance(v, torch.Tensor) and v.is_floating_point()})
        loss, _ = tmapper._map_loss_pool(
            dec, feat.requires_grad_(True), tpool, ts.pos, draw, "geometry",
            topts, tropts, ppf)
        gB, = torch.autograd.grad(loss, [dec.geo.B])
        out.append(gB.double().numpy())
    return out


@pytest.mark.parametrize("seed", range(8))
def test_geo_B_first_gradient_within_rounding(scene, seed):
    g_jax, g_port, g_port64 = _first_geo_B_grads(scene,
                                                 jax.random.PRNGKey(seed))
    gap = np.abs(g_port - g_jax).max()
    rounding = np.abs(g_port - g_port64).max()
    assert gap <= GEO_B_GRAD_RATIO * rounding, (gap, rounding)
    assert gap <= GEO_B_GRAD_ATOL, gap
    assert np.array_equal(np.sign(g_port), np.sign(g_jax))
    assert np.abs(g_jax).max() > 1e-2  # the gradient is not vacuous


@pytest.mark.parametrize("n_geo,n_col,chunk", [
    (401, 1099, 64), (121, 179, 64), (21, 39, 16), (64, 0, 64), (0, 10, 4),
])
def test_stage_chunks_split_the_stages(n_geo, n_col, chunk):
    """Every iteration once, geometry before color, no chunk holding both
    stages or more than `chunk` iterations, and the first chunk of each
    stage marked."""
    chunks = tmapper.stage_chunks(n_geo, n_col, chunk)
    assert sum(g for g, _, _ in chunks) == n_geo
    assert sum(c for _, c, _ in chunks) == n_col
    n_geo_chunks = -(-n_geo // chunk)
    for i, (g, c, first) in enumerate(chunks):
        assert bool(g) != bool(c) and g + c <= chunk
        assert bool(g) == (i < n_geo_chunks)
        assert first == (i in (0, n_geo_chunks))


def _geo_B_report():
    """Print the numbers behind GEO_B_GRAD_RATIO and the geo.B note of the
    module docstring, for keys 0-7: the first gradient's port-vs-JAX gap
    beside each package's float32-vs-float64 gap (JAX's under
    jax.enable_x64 with its draws kept at their float32/int32 values), the
    geometry trunk's ReLU units whose sign differs between the port's
    float32 and float64 passes, and after a whole chunk (3 geometry + 1
    color iterations) the share of geo.B's entries beyond 1e-4 between the
    port, JAX and the port in float64. Run from the repository's root:
    PYTHONPATH=. python tests/test_torch_mapping.py (a few minutes on a
    CPU)."""
    from loopy_slam_torch.models import decoder as tdecoder

    gen = scene.__wrapped__()
    sc = next(gen)
    cfg, ds, mopts, ropts = sc["cfg"], sc["ds"], sc["mopts"], sc["ropts"]
    s, params = sc["state"], sc["params"]
    frames = [ds[i] for i in (0, 2)]
    kc, kd, kp = (np.stack([f[i] for f in frames]) for i in (1, 2, 3))
    ppf, n_geo, n_col = 60, 3, 1
    P = mopts.pixel_pool_factor * ppf
    lrs_geo, lrs_col = [0.001, 0.03, 0.0], [0.005, 0.005, 0.005]
    feat_mask = np.asarray(jmapper.frustum_feature_mask(
        s.pos, s.count, jnp.asarray(kp[-1]), jnp.asarray(kd[-1]), mopts))
    topts = tmapper.MapperOptions(
        **{k: v for k, v in mopts._asdict().items()
           if k in tmapper.MapperOptions._fields})
    ts = convert_state(s)

    def jax_first_grad_f64(key):
        kpool, k = jax.random.split(key)
        pool = jmapper._build_pool(s.pos, s.grid, jnp.asarray(kc),
                                   jnp.asarray(kd), jnp.asarray(kp), None,
                                   kpool, mopts, ropts, P)
        _, kiter = jax.random.split(k)
        host = jax.tree.map(np.asarray, ({"dec": params, "feat": s.feat},
                                         pool, s.pos))
        randint = jax.random.randint
        with jax.enable_x64(True):
            jax.random.randint = (lambda k_, shape, lo, hi, dtype=None:
                                  randint(k_, shape, lo, hi, jnp.int32))
            try:
                tr, pl, pos = jax.tree.map(
                    lambda a: jnp.asarray(a, jnp.float64
                                          if a.dtype == np.float32
                                          else a.dtype), host)
                _, g = jax.value_and_grad(jmapper._map_loss_pool,
                                          has_aux=True)(
                    tr, pl, pos, kiter, "geometry", mopts, ropts, ppf, None)
                return np.asarray(g["dec"]["geo"]["B"])
            finally:
                jax.random.randint = randint

    relu_signs = []
    trunk = tdecoder._trunk

    def recording_trunk(layers, fc_c, out, emb, c, act, bf16):
        # the port's own trunk, its ReLU recording each pre-activation's sign
        if act is torch.relu:
            def act(pre):
                relu_signs.append(pre.detach() > 0)
                return torch.relu(pre)
        return trunk(layers, fc_c, out, emb, c, act, bf16)

    def jax_chunk(key):
        tr = jax.tree.map(jnp.copy, {"dec": params, "feat": s.feat})
        jt, _, _ = jmapper.optimize_map(
            tr, jadam.init(tr), jdec.trainable_mask(params, cfg),
            jnp.asarray(feat_mask), s.pos, s.grid, jnp.asarray(kc),
            jnp.asarray(kd), jnp.asarray(kp), None, key, jnp.asarray(n_geo),
            jnp.asarray(n_col), jnp.asarray(lrs_geo), jnp.asarray(lrs_col),
            mopts, ropts, ppf, False)
        return np.asarray(jt["dec"]["geo"]["B"], np.float64)

    def port_chunk(key, f64):
        draw = ReplayDraws(mapper_draws(key, 2, P, ppf, ropts.n_surface,
                                        ropts.c_dim, mopts.H, mopts.W, n_geo,
                                        n_col), "cpu")
        dec = decoders_from_numpy(to_np(params), "cpu", bf16_trunks=False)
        feat, build = ts.feat, tmapper._build_pool

        def build_f64(*args, **kw):
            pool = build(*args, **kw)
            return pool._replace(**{
                f: v.double() for f, v in pool._asdict().items()
                if isinstance(v, torch.Tensor) and v.is_floating_point()})

        if f64:
            dec, feat = dec.double(), feat.double()
            tmapper._build_pool = build_f64
        try:
            tmapper.optimize_map(
                dec, feat, None, t_mask(dec, cfg), t(feat_mask), ts.pos,
                ts.grid, t(kc), t(kd), t(kp), draw, n_geo, n_col, lrs_geo,
                lrs_col, topts, port_render_options(ropts), ppf)
        finally:
            tmapper._build_pool = build
        return dec.geo.B.detach().double().numpy()

    def beyond(a, b):
        return f"{np.mean(np.abs(a - b) > 1e-4):.4f}"

    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        tdecoder._trunk = recording_trunk
        try:
            relu_signs.clear()
            g_jax, g_port, g_port64 = _first_geo_B_grads(sc, key)
        finally:
            tdecoder._trunk = trunk
        half = len(relu_signs) // 2
        flips = [int((a != b).sum()) for a, b in
                 zip(relu_signs[:half], relu_signs[half:])]
        g_jax64 = jax_first_grad_f64(key)
        b_jax, b_port = jax_chunk(key), port_chunk(key, False)
        b_port64 = port_chunk(key, True)
        print(f"key {seed}: first gradient |g| max "
              f"{np.abs(g_jax).max():.3e}, port-JAX "
              f"{np.abs(g_port - g_jax).max():.3e}, port f32-f64 "
              f"{np.abs(g_port - g_port64).max():.3e}, JAX f32-f64 "
              f"{np.abs(g_jax - g_jax64).max():.3e}, sign flips "
              f"{int((np.sign(g_port) != np.sign(g_jax)).sum())}, ReLU "
              f"units flipped f32-f64 by layer {flips} | chunk: geo.B "
              f"beyond 1e-4 port-JAX {beyond(b_port, b_jax)}, port "
              f"f32-f64 {beyond(b_port, b_port64)}, JAX-port f64 "
              f"{beyond(b_jax, b_port64)}", flush=True)


if __name__ == "__main__":
    import torch_cpu

    with torch_cpu.cpu_settings():
        _geo_B_report()
