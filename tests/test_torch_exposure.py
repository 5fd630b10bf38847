"""The port's exposure compensation (model.encode_exposure, the ScanNet
configs) against the JAX package, on the CPU, with the same seeded inputs
and JAX's random draws replayed.

Tolerances:
  * `exposure_affine`: 1e-6 (an 8 -> 128 -> 12 MLP in f32 on both sides;
    the difference is summation order).
  * the renderer with an exposure latent, and in its deferred mode (raw
    logits): 1e-4 relative with f32 trunks, 2e-2 with bf16 trunks, on
    values and gradients: the renderer's own tolerances
    (tests/test_torch_decoder_renderer.py gives the reasons); the raw
    logits, which cross zero where a relative bound has nothing to scale,
    with an absolute floor of 1e-5 of their largest magnitude (the
    post-sigmoid colors hold the same trunk-order differences within
    1e-4 relative).
  * one tracked frame with the exposure latent and MLP optimized beside
    the pose: first loss 1e-4 relative, best loss 1e-3, pose and final
    latent 2e-4 (the tracked-frame tolerances of
    tests/test_torch_mapping.py and the reasons given there); the MLP's
    entries within 1e-3 (they move up to 1e-2 in the twelve lr-0.001
    steps; measured 5.3e-4): Adam's normalised step turns a last-bit
    difference of a small gradient into a visible share of a step.
  * one mapping chunk's loss terms with the window's exposure latents
    (deferred per-frame affine in the color stage): 1e-3 relative, and the
    trained latent within the summed learning-rate steps of JAX's.
  * a JAX-written checkpoint with exposure state: restored exactly, and a
    render under its latent and color-decoder snapshot within 1e-4.
The session with exposure (the ScanNet fixture through the CLI) is in
tests/test_torch_replica_scannet.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loopy_slam_torch.config import load_config as tload
from loopy_slam_torch.convert import decoders_from_numpy
from loopy_slam_torch.mapping import mapper as tmapper
from loopy_slam_torch.mapping import tracker as ttracker
from loopy_slam_torch.models import decoder as tdec
from loopy_slam_torch.models import renderer as trend
from loopy_slam_torch.models.decoder import trainable_mask as t_mask
from loopy_slam_torch.ops import camera as tcam
from loopy_slam_torch.ops import knn as tknn
from loopy_slam_torch.ops.draws import ReplayDraws
from loopy_slam_torch.slam import LoopySLAM
from loopy_slam_tpu import slam as jslam_mod
from loopy_slam_tpu.config import load_config as jload
from loopy_slam_tpu.mapping import mapper as jmapper
from loopy_slam_tpu.mapping import tracker as jtracker
from loopy_slam_tpu.models import decoder as jdec
from loopy_slam_tpu.models import renderer as jrend
from loopy_slam_tpu.models.renderer import RenderOptions
from loopy_slam_tpu.ops import adam as jadam
from loopy_slam_tpu.ops import camera as jcam
from loopy_slam_tpu.ops import knn as jknn
from loopy_slam_tpu.ops.camera import tensor_from_c2w
from test_torch_decoder_renderer import (TOL, _scene, assert_close_scaled,
                                         bf16_mode, jax_params,
                                         leaves_with_names)
from test_torch_mapping import (convert_state, mapper_draws,
                                port_render_options, scene, tracker_draws)
from torch_cpu import cpu_settings, torch_cpu  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_cpu")
_FIXTURES = (bf16_mode, scene)  # fixtures imported for this module's tests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(a):
    return torch.as_tensor(np.array(a))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def exposure_params(params, seed=0):
    """params with an exposure MLP of useful scale: the init's 0.01-scale
    weights give a near-zero color rotation, which would hide the
    rendered colors from the comparison."""
    rng = np.random.default_rng(seed)
    e = params["col"]["exposure"]
    b2 = np.zeros(12, np.float32)
    b2[[0, 4, 8]] = 1.0  # near the identity rotation
    new = {"w1": rng.normal(0, 0.4, np.shape(e["w1"])),
           "b1": rng.normal(0, 0.1, np.shape(e["b1"])),
           "w2": rng.normal(0, 0.05, np.shape(e["w2"])),
           "b2": b2}
    new = {k: jnp.asarray(v, jnp.float32) for k, v in new.items()}
    return {**params, "col": {**params["col"], "exposure": new}}


def test_exposure_affine_matches():
    params = exposure_params(jax_params(3))
    dec = decoders_from_numpy(to_np(params), "cpu")
    lat = np.random.default_rng(1).normal(0, 1, (5, 8)).astype(np.float32)
    jrot, jtr = jax.vmap(lambda e: jdec.exposure_affine(params["col"], e))(
        jnp.asarray(lat))
    rot, tr = tdec.exposure_affine(dec.col.exposure, t(lat))
    np.testing.assert_allclose(rot.detach().numpy(), np.asarray(jrot),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tr.detach().numpy(), np.asarray(jtr),
                               atol=1e-6, rtol=1e-6)
    one_rot, one_tr = tdec.exposure_affine(dec.col.exposure, t(lat[2]))
    assert one_rot.shape == (3, 3) and one_tr.shape == (3,)
    np.testing.assert_allclose(one_rot.detach().numpy(), np.asarray(jrot[2]),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("mode", ["latent", "deferred"])
def test_decode_with_exposure_values_and_grads(rng, bf16_mode, bf16, mode):
    """decode_neighbors with encode_exposure: through the latent's affine
    (tracking, renders) or raw logits (the mapper's deferred path);
    values and gradients w.r.t. features, decoder parameters (the
    exposure MLP included) and the latent."""
    bf16_mode(bf16)
    tol = TOL[bf16]
    pos, valid, feats, cam7, i, j, z = _scene(rng)
    T, M, k, cell = 2 ** 10, 32, 8, 0.16
    ropts = jrend.RenderOptions(radius_query=cell, table_size=T,
                                max_per_cell=M, encode_exposure=True)
    topts = port_render_options(ropts)
    fx, fy, cx, cy = 8.0, 8.0, 8.0, 6.0
    n = z.size
    key = jax.random.PRNGKey(11)
    kg, kc = jax.random.split(key)
    noise = [np.asarray(jax.random.normal(kg, (n, 32))),
             np.asarray(jax.random.normal(kc, (n, 32)))]
    wc = rng.normal(size=(n, 3)).astype(np.float32)
    lat = rng.normal(0, 1, 8).astype(np.float32)
    params = exposure_params(jax_params(2))
    grid = jknn.build(jnp.asarray(pos), jnp.asarray(valid), cell, T, M)
    use_lat = mode == "latent"

    def jloss(params, feats, ef):
        c2w = jcam.c2w_from_tensor(jnp.asarray(cam7))
        ro, rd = jcam.rays_from_uv(jnp.asarray(i), jnp.asarray(j), c2w,
                                   fx, fy, cx, cy)
        pts = (ro[:, None] + rd[:, None] * jnp.asarray(z)[..., None]
               ).reshape(-1, 3)
        D, I, nn = jknn.query(grid, jnp.asarray(pos), pts, k, cell, T, M)
        both = jrend.gather_featpos(feats, jnp.asarray(pos), I)
        _, rgb, _ = jrend.decode_neighbors(
            params, pts, key, ropts, "color", D, both, nn, cell,
            exposure_feat=ef if use_lat else None)
        return jnp.sum(rgb * wc), rgb

    (_, jrgb), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        params, jnp.asarray(feats), jnp.asarray(lat))

    dec = decoders_from_numpy(to_np(params), "cpu", bf16_trunks=bf16)
    tgrid = tknn.build(t(pos), t(valid), cell, T, M)
    tf = t(feats).requires_grad_(True)
    tl = t(lat).requires_grad_(True)
    c2w = tcam.c2w_from_tensor(t(cam7))
    ro, rd = tcam.rays_from_uv(t(i), t(j), c2w, fx, fy, cx, cy)
    pts = (ro[:, None] + rd[:, None] * t(z)[..., None]).reshape(-1, 3)
    D, I, nn = tknn.query(tgrid, t(pos), pts, k, cell)
    both = trend.gather_featpos(tf, t(pos), I)
    _, rgb, _ = trend.decode_neighbors(
        dec, pts, ReplayDraws(noise, "cpu"), topts, "color", D, both, nn,
        cell, exposure_feat=tl if use_lat else None)
    loss = torch.sum(rgb * t(wc))
    named = dict(dec.named_parameters())
    names = list(named)
    grads = torch.autograd.grad(loss, [named[m] for m in names] + [tf, tl],
                                allow_unused=True)
    # raw logits cross zero, where a relative bound has nothing to scale:
    # their floor is 1e-5 of the largest magnitude (f32 trunks)
    floor = tol["atol"] if use_lat else max(tol["atol"], 1e-5)
    assert_close_scaled(rgb.detach(), jrgb, tol["rtol"], floor)
    if not use_lat:  # raw logits, not colors
        assert float(np.abs(np.asarray(jrgb)).max()) > 1.0
    gr = tol["grad_rtol"]
    jparam_g = dict(leaves_with_names(to_np(jg[0])))
    for name, g in zip(names, grads[:-2]):
        ref = jparam_g[name]
        if g is None:
            assert not np.any(ref), name
        else:
            assert_close_scaled(g, ref, gr, gr)
    assert_close_scaled(grads[-2], jg[1], gr, gr)
    if use_lat:
        assert np.abs(np.asarray(jg[2])).max() > 0
        assert_close_scaled(grads[-1], jg[2], gr, gr)
        assert np.abs(np.asarray(jg[0]["col"]["exposure"]["w1"])).max() > 0
    else:
        assert grads[-1] is None and not np.any(np.asarray(jg[2]))


def test_track_one_frame_with_exposure_matches(scene):
    cfg, ds = scene["cfg"], scene["ds"]
    cfg = {**cfg, "model": {**cfg["model"], "encode_exposure": True},
           "tracking": {**cfg["tracking"], "pixels": 120, "iters": 12,
                        "pool_factor": 4, "knn_refresh": 10}}
    topts = jtracker.TrackOptions.from_cfg(cfg)
    ropts = RenderOptions.from_cfg(
        cfg, sigmoid_coef=cfg["rendering"]["sigmoid_coef_tracker"])
    assert topts.encode_exposure and ropts.encode_exposure
    _, color, depth, c2w = ds[2]
    init = c2w.copy()
    init[:3, 3] += np.array([0.01, -0.008, 0.006], np.float32)
    cam7 = tensor_from_c2w(init)
    lat = np.random.default_rng(2).normal(0, 0.5, 8).astype(np.float32)
    params = exposure_params(scene["params"], seed=3)
    key = jax.random.PRNGKey(9)
    s = scene["state"]
    jout = jtracker.track_frame(
        params, s.pos, s.grid, s.feat, jnp.asarray(color),
        jnp.asarray(depth), jnp.asarray(cam7), key, topts, ropts,
        exposure_feat=jnp.asarray(lat), health=jnp.zeros(3))
    lengths = ttracker.warmup_blocks(topts.iters, topts.knn_refresh)
    draws = tracker_draws(
        key, lengths, topts.pixels * topts.pool_factor, topts.pixels,
        ropts.n_surface, ropts.c_dim, topts.ignore_edge_H,
        topts.H - topts.ignore_edge_H, topts.ignore_edge_W,
        topts.W - topts.ignore_edge_W)
    ts = convert_state(s)
    dec = decoders_from_numpy(to_np(params), "cpu", bf16_trunks=False)
    tout = ttracker.track_frame(
        dec, ts.pos, ts.grid, ts.feat, t(color), t(depth), t(cam7),
        ReplayDraws(draws, "cpu"), ttracker.TrackOptions(
            **{k: v for k, v in topts._asdict().items()
               if k in ttracker.TrackOptions._fields}),
        port_render_options(ropts), health=torch.zeros(3),
        exposure_feat=t(lat))
    j_cam, _, j_first, j_best, j_ef, j_mlp = (jout[0], jout[1], jout[2],
                                              jout[3], jout[4], jout[5])
    np.testing.assert_allclose(tout.first_loss.numpy(), np.asarray(j_first),
                               rtol=1e-4)
    np.testing.assert_allclose(tout.best_loss.numpy(), np.asarray(j_best),
                               rtol=1e-3)
    np.testing.assert_allclose(tout.cam7.numpy(), np.asarray(j_cam),
                               atol=2e-4)
    # the latent and the MLP moved, and as JAX's did
    assert np.abs(np.asarray(j_ef) - lat).max() > 1e-3
    np.testing.assert_allclose(tout.exposure_feat.numpy(), np.asarray(j_ef),
                               atol=2e-4)
    for name in ("w1", "b1", "w2", "b2"):
        got = getattr(tout.exposure_mlp, name).numpy()
        moved = np.abs(np.asarray(j_mlp[name])
                       - np.asarray(params["col"]["exposure"][name]))
        assert moved.max() > 5e-3, name  # each part of the MLP trained
        np.testing.assert_allclose(got, np.asarray(j_mlp[name]), atol=1e-3)
    # the decoder itself is left as it was (the session writes back)
    np.testing.assert_array_equal(
        dec.col.exposure.w1.detach().numpy(),
        np.asarray(params["col"]["exposure"]["w1"]))


def test_mapping_chunk_with_exposure_matches(scene):
    cfg, ds = scene["cfg"], scene["ds"]
    cfg = {**cfg, "model": {**cfg["model"], "encode_exposure": True}}
    mopts = scene["mopts"]._replace(encode_exposure=True)
    ropts = scene["ropts"]._replace(encode_exposure=True)
    frames = [ds[i] for i in (0, 2)]
    kc = np.stack([f[1] for f in frames])
    kd = np.stack([f[2] for f in frames])
    kp = np.stack([f[3] for f in frames])
    rng = np.random.default_rng(4)
    kf_exp = rng.normal(0, 0.5, (2, 8)).astype(np.float32)
    exp = rng.normal(0, 0.5, 8).astype(np.float32)
    s = scene["state"]
    params = exposure_params(scene["params"], seed=5)
    feat_mask = np.asarray(jmapper.frustum_feature_mask(
        s.pos, s.count, jnp.asarray(kp[-1]), jnp.asarray(kd[-1]), mopts))
    ppf, n_geo, n_col = 60, 2, 2
    lrs_geo, lrs_col = [0.001, 0.03, 0.0], [0.005, 0.005, 0.005]
    key = jax.random.PRNGKey(4)
    trainable = jax.tree.map(jnp.copy, {"dec": params, "feat": s.feat,
                                        "exp": jnp.asarray(exp)})
    jt, _, jaux = jmapper.optimize_map(
        trainable, jadam.init(trainable), jdec.trainable_mask(params, cfg),
        jnp.asarray(feat_mask), s.pos, s.grid, jnp.asarray(kc),
        jnp.asarray(kd), jnp.asarray(kp), None, key, jnp.asarray(n_geo),
        jnp.asarray(n_col), jnp.asarray(lrs_geo), jnp.asarray(lrs_col),
        mopts, ropts, ppf, False, kf_exposure=jnp.asarray(kf_exp))
    draws = mapper_draws(key, 2, mopts.pixel_pool_factor * ppf, ppf,
                         ropts.n_surface, ropts.c_dim, mopts.H, mopts.W,
                         n_geo, n_col)
    ts = convert_state(s)
    dec = decoders_from_numpy(to_np(params), "cpu", bf16_trunks=False)
    feat, _, taux, texp = tmapper.optimize_map(
        dec, ts.feat, None, t_mask(dec, cfg), t(feat_mask), ts.pos, ts.grid,
        t(kc), t(kd), t(kp), ReplayDraws(draws, "cpu"), n_geo, n_col,
        lrs_geo, lrs_col, tmapper.MapperOptions(
            **{k: v for k, v in mopts._asdict().items()
               if k in tmapper.MapperOptions._fields}),
        port_render_options(ropts), ppf, kf_exposure=t(kf_exp), exp=t(exp))
    ja = [float(a) for a in jaux]
    ta = [float(a) for a in taux]
    assert ta[2] == ja[2] > 0 and ja[1] > 0
    np.testing.assert_allclose(ta[:2], ja[:2], rtol=1e-3)
    jexp = np.asarray(jt["exp"])
    assert np.abs(jexp - exp).max() > 1e-4  # the latent trained
    assert np.abs(texp.numpy() - jexp).max() <= 2 * 0.001 * (n_geo + n_col)
    np.testing.assert_allclose(texp.numpy(), jexp, atol=2e-4)


# ---------------------------------------------------------------------------
# a JAX checkpoint with exposure state
# ---------------------------------------------------------------------------

TINY = """inherit_from: "{room}"
data: {{n_frames: 5, output: "{out}"}}
cam: {{H: 60, W: 80, fx: 60.0, fy: 60.0, cx: 39.5, cy: 29.5}}
model: {{bf16_trunks: False, encode_exposure: True}}
tracking: {{pixels: 200, iters: 12, ignore_edge_W: 4, ignore_edge_H: 4,
  vis_freq: 0}}
mapping: {{every_frame: 2, pixels: 400, pixels_adding: 800, iters: 30,
  iters_first: 60, geo_iter_first: 20, mapping_window_size: 4,
  keyframe_every: 2, color_refine: False, segment_strategy: none,
  vis_freq: 0}}
pointcloud: {{capacity: 32768, cell_table_size: 65536, radius_add: 0.08,
  radius_query: 0.16, radius_min: 0.04}}
"""


def test_jax_checkpoint_with_exposure_restores_and_renders(tmp_path):
    from loopy_slam_tpu.utils.io import save_checkpoint

    room = os.path.join(REPO, "configs", "Synthetic", "room.yaml")
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY.format(room=room, out=tmp_path / "jax"))
    cfg = jload(str(cfg_path))
    js = jslam_mod.LoopySLAM(cfg, output=str(tmp_path / "jax"))
    rng = np.random.default_rng(6)
    try:
        js.params = exposure_params(js.params, seed=7)
        state = js.map_state
        _, c, d, p = js.dataset[0]
        state, _ = jmapper.add_points_from_frame(
            state, jnp.asarray(c), jnp.asarray(d), jnp.asarray(p),
            jnp.asarray(p), jax.random.PRNGKey(1), js.mopts_map, js.mopts,
            800, overlap=None)
        js.map_state = state
        js.estimate_c2w[:2] = js.gt_c2w[:2] = [js.dataset[i][3]
                                              for i in range(2)]
        js.exposure_feat = jnp.asarray(rng.normal(0, 0.5, 8), jnp.float32)
        color, depth = jslam_mod._upload_frame(c, d)
        js._add_keyframe(0, color, depth, p, p)
        js.keyframe_list.append(0)
        js.keyframe_global_list.append(0)
        js.mapped_exposure[0] = np.asarray(js.exposure_feat)
        snap = jax.tree.map(np.asarray, exposure_params(js.params, 8)["col"])
        save_checkpoint(str(tmp_path / "jax" / "ckpts" / "color_decoder"
                            / "00000.pkl"), snap)
        js.exposure_feat = jnp.asarray(rng.normal(0, 0.5, 8), jnp.float32)
        js.prev_mapped_idx = 0
        js.finalize(1, final=False)
        keys = [jax.random.PRNGKey(10), jax.random.PRNGKey(11)]
        it = iter(keys)
        js._next_key = lambda: next(it)
        ef = js.mapped_exposure[0]
        _, _, d1, p1 = js.dataset[1]
        jd, jc = js.render_img(p1, d1, exposure_feat=ef, col_params=snap)
        draws = []
        for k in keys:
            kg, kc = jax.random.split(k)
            n = 4096 * js.ropts_mapper.n_surface
            draws += [np.asarray(jax.random.normal(kg, (n, 32))),
                      np.asarray(jax.random.normal(kc, (n, 32)))]
    finally:
        jdec.set_bf16_trunks(True)
    with cpu_settings():
        ps = LoopySLAM(tload(str(cfg_path)), output=str(tmp_path / "port"),
                       device="cpu")
        try:
            assert ps.restore(str(tmp_path / "jax" / "ckpts" / "00001.pkl")) \
                == 2
            np.testing.assert_array_equal(ps.exposure_feat.numpy(),
                                          np.asarray(js.exposure_feat))
            assert set(ps.kf_exposure) == {0} and set(ps.mapped_exposure) \
                == {0}
            np.testing.assert_array_equal(ps.kf_exposure[0],
                                          js.kf_exposure[0])
            np.testing.assert_array_equal(ps.mapped_exposure[0], ef)
            np.testing.assert_array_equal(
                ps.dec.col.exposure.w2.detach().numpy(),
                np.asarray(js.params["col"]["exposure"]["w2"]))
            ps.draw = ReplayDraws(draws, "cpu")
            pd, pc = ps.render_img(p1, d1, exposure_feat=ef,
                                   col_params=snap)
        finally:
            ps.close()
    assert (jd > 0).mean() > 0.5
    assert_close_scaled(pd, jd, 1e-4, 1e-6)
    assert_close_scaled(pc, jc, 1e-4, 1e-6)
    assert 0.0 < float(np.asarray(jc).min()) and float(
        np.asarray(jc).max()) < 1.0  # colors through the affine's sigmoid
