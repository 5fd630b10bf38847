"""The dynamic query radius and the color-gradient pixel picks of the port
(ROADMAP.md Queue 1 item 15) against the JAX package, on the CPU, with
the same seeded inputs, JAX's random draws replayed into the port
(ops/draws.ReplayDraws) and f32 trunks on both sides.

Tolerances:
  * the gradient ops (gray, Sobel, radius maps, picks): bit-equal, with
    the session's numpy generator in the same state after the picks: both
    sides run the same float64 numpy code;
  * a render with a per-ray radius: 1e-4 relative (1e-6 absolute floor),
    as every f32-trunk render of the port: the summation order inside
    matmuls and reductions and libm's last bit differ, amplified by the
    Fourier phases;
  * insertion (dynamic radius, radius_min for gradient picks, and both):
    the same gate, count and index fill, positions within 1e-6: the
    k-NN gate is bit-equal and the spawned positions are f32 on both sides;
  * a tracked frame from the gradient pool with per-pixel radii: the
    first loss within 1e-4 relative and the pose within the existing 2e-4
    per component (Adam on f32 gradients that differ in the last bits);
    the best loss within 5e-3 relative (the uniform-pixel test holds
    1e-3): it is the loss at the best of twelve poses that already differ
    by ~1e-4, and the gradient pool's pixels sit on color edges, where
    the color term changes fastest with the pose (measured: 2.1e-3; JAX
    alone moves its first loss by 1e-5 between two compiles of the same
    frame);
  * a mapping chunk with per-frame radius maps: the existing loss-term
    tolerance (1e-3 relative) and 99.5% of entries within 1e-4 (Adam's
    normalised step turns a sign difference of a near-zero gradient into a
    full step on one side; see tests/test_torch_mapping.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import small_cfg
from loopy_slam_torch.convert import decoders_from_numpy
from loopy_slam_torch.mapping import mapper as tmapper
from loopy_slam_torch.mapping import point_cloud as tpc
from loopy_slam_torch.mapping import tracker as ttracker
from loopy_slam_torch.models import renderer as trend
from loopy_slam_torch.models.decoder import trainable_mask as t_mask
from loopy_slam_torch.ops import image as timage
from loopy_slam_torch.ops.draws import ReplayDraws
from loopy_slam_torch.slam import LoopySLAM
from loopy_slam_tpu.mapping import mapper as jmapper
from loopy_slam_tpu.mapping import point_cloud as jpc
from loopy_slam_tpu.mapping import tracker as jtracker
from loopy_slam_tpu.models import decoder as jdec
from loopy_slam_tpu.models import renderer as jrend
from loopy_slam_tpu.models.renderer import RenderOptions
from loopy_slam_tpu.ops import adam as jadam
from loopy_slam_tpu.ops import camera as jcam
from loopy_slam_tpu.ops import image as jimage
from loopy_slam_tpu.ops.camera import tensor_from_c2w
from loopy_slam_tpu.utils.datasets import Synthetic
from test_torch_mapping import (convert_state, leaves_with_names,
                                mapper_draws, port_render_options, t, to_np)
from torch_cpu import torch_cpu  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_cpu")

# tum.yaml's radius settings (pointcloud.radius_add_max/min, the ratio and
# the gradient threshold of configs/point_slam.yaml's defaults)
RADIUS = dict(radius_add_max=0.08, radius_add_min=0.02, radius_query_ratio=2,
              color_grad_threshold=0.15)


def _images(seed, H=30, W=40):
    """A noisy color image with smooth regions and edges, and a depth map
    with holes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    color = np.stack([0.5 + 0.4 * np.sin(9 * xx + 3 * yy),
                      (xx > 0.4).astype(float) * 0.6 + 0.2,
                      0.3 + 0.3 * yy], -1)
    color = np.clip(color + rng.normal(0, 0.02, color.shape), 0, 1)
    depth = rng.uniform(0.5, 6.0, (H, W)) * (rng.uniform(size=(H, W)) > 0.1)
    return color.astype(np.float32), depth.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gradient_ops_bit_equal(seed):
    color, depth = _images(seed)
    np.testing.assert_array_equal(timage.rgb2gray(color),
                                  jimage.rgb2gray(color))
    g = timage.rgb2gray(color)
    np.testing.assert_array_equal(timage.sobel_grad_mag(g),
                                  jimage.sobel_grad_mag(g))
    for a, b in zip(timage.dynamic_radius_maps(color, **RADIUS),
                    jimage.dynamic_radius_maps(color, **RADIUS)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for kw in ({}, {"gt_depth": depth}, {"gt_depth": depth,
                                         "depth_limit": True}):
        ft, gt = timage.select_pixels_by_grad(3, 27, 4, 36, 20, color, **kw)
        fj, gj = jimage.select_pixels_by_grad(3, 27, 4, 36, 20, color, **kw)
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(gt, gj)
        assert 0 < ft.size < 300


def _radius_cfg(**over):
    cfg = small_cfg(use_dynamic_radius=True, **over)
    cfg["model"]["bf16_trunks"] = False
    cfg["pointcloud"].update(RADIUS)
    return cfg


def test_session_pixel_picks_match_jax(tmp_path):
    """The session's gradient pools (the tracker's, resampled to 15 x
    pixels, and the mapper's insertion picks) are the JAX session's: the
    same pixels from the same numpy generator state, which both leave in
    the same state."""
    cfg = _radius_cfg(tracking={"sample_with_color_grad": True},
                      mapping={"pixels_based_on_color_grad": 40})
    slam = LoopySLAM(cfg, output=str(tmp_path), device="cpu")
    try:
        ds = slam.dataset
        rng = np.random.default_rng(cfg["setup_seed"])
        t_cfg, m_cfg = cfg["tracking"], cfg["mapping"]
        for i in (0, 3):
            _, color, depth, _ = ds[i]
            # the JAX session's steps (loopy_slam_tpu/slam.py track_frame
            # and map_frame)
            flat, _ = jimage.select_pixels_by_grad(
                4, slam.H - 4, 4, slam.W - 4, t_cfg["pixels"], color,
                gt_depth=depth, depth_limit=t_cfg["depth_limit"], rng=rng)
            if flat.size != 15 * t_cfg["pixels"]:
                flat = rng.choice(flat, 15 * t_cfg["pixels"], replace=True)
            np.testing.assert_array_equal(
                slam._track_pixel_pool(color, depth), flat)
            n = m_cfg["pixels_based_on_color_grad"]
            flat, _ = jimage.select_pixels_by_grad(0, slam.H, 0, slam.W, n,
                                                   color, rng=rng)
            pick = rng.choice(flat.size, size=min(n, flat.size),
                              replace=False)
            np.testing.assert_array_equal(slam._grad_insert_pixels(color),
                                          flat[pick])
            assert slam.nprng.bit_generator.state == rng.bit_generator.state
    finally:
        slam.close()


@pytest.fixture(scope="module")
def scene():
    """A JAX map of frame 0 inserted with the dynamic add radius, after a
    short JAX mapping run with its query-radius map; f32 trunks."""
    jdec.set_bf16_trunks(False)
    cfg = _radius_cfg()
    ds = Synthetic(cfg)
    _, color, depth, c2w = ds[0]
    mopts_map = jpc.MapOptions.from_cfg(cfg)
    assert mopts_map.max_per_cell == 64  # the dynamic radius's grid
    mopts = jmapper.MapperOptions.from_cfg(cfg)
    ropts = RenderOptions.from_cfg(cfg)
    maps = {i: jimage.dynamic_radius_maps(ds[i][1], **RADIUS)
            for i in (0, 2)}
    state = jpc.init_map(mopts_map)
    params = jdec.init_decoders(jax.random.PRNGKey(0), cfg)
    state, _ = jmapper.add_points_from_frame(
        state, jnp.asarray(color), jnp.asarray(depth), jnp.asarray(c2w),
        jnp.asarray(c2w), jax.random.PRNGKey(1), mopts_map, mopts, 2000,
        overlap=None, dynamic_r_add=jnp.asarray(maps[0][0]))
    trainable = {"dec": params, "feat": state.feat}
    trainable, _, _ = jmapper.optimize_map(
        trainable, jadam.init(trainable), jdec.trainable_mask(params, cfg),
        jpc.valid_mask(state), state.pos, state.grid, jnp.asarray(color)[None],
        jnp.asarray(depth)[None], jnp.asarray(c2w)[None],
        jnp.asarray(maps[0][1])[None], jax.random.PRNGKey(2),
        jnp.asarray(20), jnp.asarray(20), jnp.asarray([0.001, 0.03, 0.0]),
        jnp.asarray([0.005, 0.005, 0.005]), mopts, ropts, 300, True)
    state = state._replace(feat=trainable["feat"])
    yield dict(cfg=cfg, ds=ds, state=state, params=trainable["dec"],
               mopts_map=mopts_map, mopts=mopts, ropts=ropts, maps=maps)
    jdec.set_bf16_trunks(True)


def _port_opts(scene):
    mopts = scene["mopts"]
    return (tpc.MapOptions(**scene["mopts_map"]._asdict()),
            tmapper.MapperOptions(**{k: v for k, v in mopts._asdict().items()
                                     if k in tmapper.MapperOptions._fields}))


def test_render_with_per_ray_radius(scene):
    ds, ropts = scene["ds"], scene["ropts"]
    _, color, depth, c2w = ds[2]
    rng = np.random.default_rng(4)
    R, S = 64, ropts.n_surface
    i = rng.integers(0, 80, R)
    j = rng.integers(0, 60, R)
    ro, rd = jcam.rays_from_uv(jnp.asarray(i, jnp.float32),
                               jnp.asarray(j, jnp.float32), jnp.asarray(c2w),
                               60.0, 60.0, 39.5, 29.5)
    d = depth[j, i]
    rq = scene["maps"][2][1][j, i]
    assert len(np.unique(rq)) > 3  # the radius really varies per ray
    key = jax.random.PRNGKey(5)
    kg, kc = jax.random.split(key)
    noise = [np.asarray(jax.random.normal(kg, (R * S, 32))),
             np.asarray(jax.random.normal(kc, (R * S, 32)))]
    s = scene["state"]
    jout = jrend.render_batch_ray(
        scene["params"], s.pos, s.grid, s.feat, ro, rd, jnp.asarray(d),
        jnp.asarray(d > 0), key, ropts, "color", r_query=jnp.asarray(rq))
    ts = convert_state(s)
    dec = decoders_from_numpy(to_np(scene["params"]), "cpu",
                              bf16_trunks=False)
    tout = trend.render_batch_ray(
        dec, ts.pos, ts.grid, ts.feat, t(ro), t(rd), t(d), t(d > 0),
        ReplayDraws(noise, "cpu"), port_render_options(ropts), "color",
        r_query=t(rq))
    for a, b in zip(tout, jout):
        a, b = a.detach().numpy(), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(b).max(), 1.0))
    # against the scalar radius the per-ray one changes the render
    scalar = trend.render_batch_ray(
        dec, ts.pos, ts.grid, ts.feat, t(ro), t(rd), t(d), t(d > 0),
        ReplayDraws(noise, "cpu"), port_render_options(ropts), "color")
    assert (scalar[0] - tout[0]).abs().max() > 1e-4


def _assert_same_insertion(ts, tn, js, jn):
    assert int(tn) == int(jn) > 0
    assert int(ts.count) == int(js.count)
    assert int(ts.in_count) == int(js.in_count)
    cnt = int(js.count)
    np.testing.assert_allclose(ts.pos[:cnt].numpy(), np.asarray(js.pos)[:cnt],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ts.grid.cell_fill.numpy(),
                                  np.asarray(js.grid.cell_fill))
    assert int(ts.grid.n_dropped) == int(js.grid.n_dropped)


_j_add_points = jax.jit(jpc.add_points, static_argnames=("opts",
                                                         "is_pts_grad"))


@pytest.mark.parametrize("dynamic,is_grad", [(True, False), (False, True),
                                             (True, True)])
def test_add_points_radius_gates(scene, dynamic, is_grad):
    ds, mopts_map = scene["ds"], scene["mopts_map"]
    _, color, depth, c2w = ds[2]
    rng = np.random.default_rng(8)
    A = 1500
    j = rng.integers(0, 60, A)
    i = rng.integers(0, 80, A)
    ro, rd = jcam.rays_from_uv(jnp.asarray(i, jnp.float32),
                               jnp.asarray(j, jnp.float32), jnp.asarray(c2w),
                               60.0, 60.0, 39.5, 29.5)
    d, c = depth[j, i], color[j, i]
    dra = scene["maps"][2][0][j, i] if dynamic else None
    key = jax.random.PRNGKey(11)
    normals = np.asarray(jax.random.normal(
        key, (A * mopts_map.N_add, 2 * mopts_map.c_dim)))
    args = (ro, rd, jnp.asarray(d), jnp.asarray(c), jnp.asarray(d > 0))
    js, jn = _j_add_points(scene["state"], mopts_map, key, *args,
                           dynamic_r_add=None if dra is None
                           else jnp.asarray(dra), is_pts_grad=is_grad)
    tm, _ = _port_opts(scene)
    ts, tn = tpc.add_points(
        convert_state(scene["state"]), tm, ReplayDraws([normals], "cpu"),
        *(t(a) for a in args), dynamic_r_add=None if dra is None else t(dra),
        is_pts_grad=is_grad)
    _assert_same_insertion(ts, tn, js, jn)
    # the gate radius matters: the scalar radius_add gate admits another
    # number of locations
    _, jn_plain = _j_add_points(scene["state"], mopts_map, key, *args)
    assert int(jn_plain) != int(jn)


def test_add_points_at_pixels_match(scene):
    ds, mopts_map = scene["ds"], scene["mopts_map"]
    _, color, depth, c2w = ds[2]
    flat, _ = jimage.select_pixels_by_grad(0, 60, 0, 80, 300, color)
    flat = flat[np.random.default_rng(3).choice(flat.size, 300,
                                                replace=False)]
    dra = scene["maps"][2][0]
    key = jax.random.PRNGKey(12)
    normals = np.asarray(jax.random.normal(
        key, (300 * mopts_map.N_add, 2 * mopts_map.c_dim)))
    js, jn = jmapper.add_points_at_pixels(
        scene["state"], jnp.asarray(color), jnp.asarray(depth),
        jnp.asarray(c2w), jnp.asarray(flat, jnp.int32), key, mopts_map,
        scene["mopts"], dynamic_r_add=jnp.asarray(dra))
    tm, tmo = _port_opts(scene)
    ts, tn = tmapper.add_points_at_pixels(
        convert_state(scene["state"]), t(color), t(depth), t(c2w), t(flat),
        ReplayDraws([normals], "cpu"), tm, tmo, dynamic_r_add=t(dra))
    _assert_same_insertion(ts, tn, js, jn)


def selected_tracker_draws(key, lengths, n_sel, P, R, S, c):
    """JAX's draws inside _track_frame_impl's cached path with a
    pre-selected pixel pool, in the port's order (one pool index draw a
    block instead of rows and cols)."""
    out = []
    k = key
    for blk in lengths:
        k, kblk = jax.random.split(k)
        out.append(jax.random.randint(kblk, (P,), 0, n_sel))
        for _ in range(blk):
            k, kiter = jax.random.split(k)
            kpick, kdec = jax.random.split(kiter)
            kg, kc = jax.random.split(kdec)
            out += [jax.random.randint(kpick, (R,), 0, P),
                    jax.random.normal(kg, (R * S, c)),
                    jax.random.normal(kc, (R * S, c))]
    return [np.asarray(a) for a in out]


def test_track_frame_with_gradient_pool_and_radius(scene):
    cfg, ds = scene["cfg"], scene["ds"]
    cfg = {**cfg, "tracking": {**cfg["tracking"], "pixels": 120,
                               "iters": 12, "pool_factor": 4,
                               "knn_refresh": 10}}
    topts = jtracker.TrackOptions.from_cfg(cfg)
    ropts = RenderOptions.from_cfg(
        cfg, sigmoid_coef=cfg["rendering"]["sigmoid_coef_tracker"])
    _, color, depth, c2w = ds[2]
    flat, _ = jimage.select_pixels_by_grad(4, 56, 4, 76, 120, color,
                                           gt_depth=depth)
    flat = np.random.default_rng(6).choice(flat, 15 * 120, replace=True)
    sel_i, sel_j = (flat % 80).astype(np.int32), (flat // 80).astype(np.int32)
    rq = scene["maps"][2][1]
    init = c2w.copy()
    init[:3, 3] += np.array([0.01, -0.008, 0.006], np.float32)
    cam7 = tensor_from_c2w(init)
    key = jax.random.PRNGKey(9)
    s = scene["state"]
    jout = jtracker.track_frame(
        scene["params"], s.pos, s.grid, s.feat, jnp.asarray(color),
        jnp.asarray(depth), jnp.asarray(cam7), key, topts, ropts,
        sel_i=jnp.asarray(sel_i), sel_j=jnp.asarray(sel_j),
        r_query=jnp.asarray(rq), use_selected=True, health=jnp.zeros(3))
    lengths = ttracker.warmup_blocks(topts.iters, topts.knn_refresh)
    draws = selected_tracker_draws(key, lengths, sel_i.size,
                                   topts.pixels * topts.pool_factor,
                                   topts.pixels, ropts.n_surface, ropts.c_dim)
    ts = convert_state(s)
    dec = decoders_from_numpy(to_np(scene["params"]), "cpu", bf16_trunks=False)
    tout = ttracker.track_frame(
        dec, ts.pos, ts.grid, ts.feat, t(color), t(depth), t(cam7),
        ReplayDraws(draws, "cpu"), ttracker.TrackOptions(
            **{k: v for k, v in topts._asdict().items()
               if k in ttracker.TrackOptions._fields}),
        port_render_options(ropts), health=torch.zeros(3), sel_i=t(sel_i),
        sel_j=t(sel_j), r_query=t(rq))
    j_cam, _, j_first, j_best = (np.asarray(a) for a in jout[:4])
    t_cam, _, t_first, t_best = (a.detach().numpy() for a in tout[:4])
    np.testing.assert_allclose(t_first, j_first, rtol=1e-4)
    np.testing.assert_allclose(t_best, j_best, rtol=5e-3)
    np.testing.assert_allclose(t_cam, j_cam, atol=2e-4)
    assert np.abs(j_cam - cam7).max() > 1e-3  # the pose moved


def test_mapping_chunk_with_radius_maps(scene):
    cfg, ds = scene["cfg"], scene["ds"]
    mopts, ropts = scene["mopts"], scene["ropts"]
    frames = [ds[i] for i in (0, 2)]
    kc = np.stack([f[1] for f in frames])
    kd = np.stack([f[2] for f in frames])
    kp = np.stack([f[3] for f in frames])
    krq = np.stack([scene["maps"][i][1] for i in (0, 2)])
    s = scene["state"]
    params = scene["params"]
    feat_mask = np.asarray(jmapper.frustum_feature_mask(
        s.pos, s.count, jnp.asarray(kp[-1]), jnp.asarray(kd[-1]), mopts))
    ppf, n_geo, n_col = 60, 3, 1
    lrs_geo, lrs_col = [0.001, 0.03, 0.0], [0.005, 0.005, 0.005]
    key = jax.random.PRNGKey(4)
    trainable = jax.tree.map(jnp.copy, {"dec": params, "feat": s.feat})
    jt, _, jaux = jmapper.optimize_map(
        trainable, jadam.init(trainable), jdec.trainable_mask(params, cfg),
        jnp.asarray(feat_mask), s.pos, s.grid, jnp.asarray(kc),
        jnp.asarray(kd), jnp.asarray(kp), jnp.asarray(krq), key,
        jnp.asarray(n_geo), jnp.asarray(n_col), jnp.asarray(lrs_geo),
        jnp.asarray(lrs_col), mopts, ropts, ppf, True)
    draws = mapper_draws(key, 2, mopts.pixel_pool_factor * ppf, ppf,
                         ropts.n_surface, ropts.c_dim, mopts.H, mopts.W,
                         n_geo, n_col)
    ts = convert_state(s)
    dec = decoders_from_numpy(to_np(params), "cpu", bf16_trunks=False)
    _, tmo = _port_opts(scene)
    feat, _, taux = tmapper.optimize_map(
        dec, ts.feat, None, t_mask(dec, cfg), t(feat_mask), ts.pos, ts.grid,
        t(kc), t(kd), t(kp), ReplayDraws(draws, "cpu"), n_geo, n_col, lrs_geo,
        lrs_col, tmo, port_render_options(ropts), ppf, kf_rq=t(krq))
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
