"""rendering.sample_near_pcl and mapping.BA of the port against the JAX
package on the CPU, on JAX-built maps, with JAX's random draws replayed
(ops/draws.ReplayDraws).

Tolerances:
  * the probe (sample_near_pcl_z_vals_raw): z-vals and `invalid`
    bit-equal. The same packed-key k-NN counts, the same float32
    linspace (XLA's i * (1 / (n - 1))) and the same operations, op by op.
  * render_batch_ray with the option on: f32 trunks 1e-4 relative, bf16
    trunks 2e-2 relative (with an absolute floor scaled to the quantity),
    the bands of tests/test_torch_decoder_renderer.py and for its reasons;
    the valid-ray mask equal.
  * render_img of a frame with holes, f32 trunks: 1e-4 relative, as
    tests/test_torch_render_resume.py holds render_img.
  * one BA mapping call (3 geometry + 1 color iterations):
    - with the map's learning rates at 0 and the poses in their window for
      two iterations: the poses within 2e-6 of JAX's (measured 3.4e-7;
      two Adam steps of 1e-3 move them by up to 2e-3), the loss terms
      within 1e-4 relative (measured 3e-6), and the poses' Adam moments
      within 1e-2 of their largest entry: single pose-gradient entries
      differ by up to 0.6% of the largest on one iteration (measured, on
      the oldest frame's row), where the losses agree to 1e-6;
    - with the map's learning rates of a mapping frame and the poses in
      their window for the last iteration only: the loss terms within
      1e-3 relative; the map, the decoders and the poses within both
      sides' summed learning-rate steps. Adam's normalised step turns a
      sign difference of a near-zero feature gradient into a full step on
      one side, and on this unoptimized map (random decoders) that moves
      the next iterations' gradients by up to ~3% of their largest entry,
      so entries differ by a fraction of a step (tests/test_torch_mapping.py
      holds a chunk entry by entry on a map optimized first); with the
      poses trained in the last iteration, the loss terms see no pose
      difference.
  * the session's BA bookkeeping (which poses train, the iteration
    window, the write-back): equal to the JAX session's, with both
    packages' optimize_map replaced by a stand-in that moves the poses to
    the same targets.
  * a tiny TUM-fixture session with sample_near_pcl, BA and the visual
    odometer: ATE below 6 cm, the JAX package's own band for its session
    with sample_near_pcl on this fixture (tests/test_sensor_fixtures.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import small_cfg
from loopy_slam_torch import run as trun
from loopy_slam_torch.config import load_config as tload
from loopy_slam_torch.convert import decoders_from_numpy, map_state_from_numpy
from loopy_slam_torch.mapping import mapper as tmapper
from loopy_slam_torch.mapping import point_cloud as tpc
from loopy_slam_torch.models import renderer as trend
from loopy_slam_torch.models.decoder import trainable_mask as t_mask
from loopy_slam_torch.ops.draws import ReplayDraws
from loopy_slam_torch.slam import LoopySLAM
from loopy_slam_torch.tools import make_sensor_fixtures as tfix
from loopy_slam_torch.utils.io import load_checkpoint
from loopy_slam_tpu import slam as jslam_mod
from loopy_slam_tpu.mapping import mapper as jmapper
from loopy_slam_tpu.mapping import point_cloud as jpc
from loopy_slam_tpu.models import decoder as jdec
from loopy_slam_tpu.models import renderer as jrend
from loopy_slam_tpu.ops import adam as jadam
from loopy_slam_tpu.ops import camera as jcam
from loopy_slam_tpu.utils.datasets import Synthetic
from torch_cpu import torch_cpu  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {False: dict(rtol=1e-4, atol=1e-6), True: dict(rtol=2e-2, atol=1e-3)}


def t(a):
    return torch.as_tensor(np.array(a))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def port_render_options(ropts):
    return trend.RenderOptions(**{f: getattr(ropts, f)
                                  for f in trend.RenderOptions._fields})


def port_map(s):
    g = s.grid
    return map_state_from_numpy(
        np.asarray(s.pos), np.asarray(s.feat), np.asarray(s.count),
        np.asarray(g.cell_data), np.asarray(g.cell_fill),
        np.asarray(g.cell_size), np.asarray(g.n_dropped), device="cpu")


def leaves_with_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in leaves_with_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_names(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def assert_close_scaled(a, b, rtol, floor):
    """|a - b| <= rtol * |b| + floor * max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=floor * scale)


@pytest.fixture(scope="module")
def scene():
    """A JAX map inserted from frames 0 and 2 of the tiny synthetic room
    (no optimization), random decoders, and the options of small_cfg with
    sample_near_pcl on."""
    cfg = small_cfg()
    cfg["rendering"]["sample_near_pcl"] = True
    ds = Synthetic(cfg)
    mopts_map = jpc.MapOptions.from_cfg(cfg)
    mopts = jmapper.MapperOptions.from_cfg(cfg)
    state = jpc.init_map(mopts_map)
    for i, key in ((0, 1), (2, 2)):
        _, c, d, p = ds[i]
        state, _ = jmapper.add_points_from_frame(
            state, jnp.asarray(c), jnp.asarray(d), jnp.asarray(p),
            jnp.asarray(p), jax.random.PRNGKey(key), mopts_map, mopts, 1500,
            overlap=None)
    params = jdec.init_decoders(jax.random.PRNGKey(0), cfg)
    return dict(cfg=cfg, ds=ds, state=state, params=params,
                mopts_map=mopts_map, mopts=mopts,
                ropts=jrend.RenderOptions.from_cfg(cfg))


def frame_rays(scene, idx, n, seed, hole_share=0.4):
    """n rays of frame idx at its pose, a share of them with depth 0 (the
    holes the probe serves), and some aimed past the map's edge."""
    rng = np.random.default_rng(seed)
    mopts = scene["mopts"]
    _, _, depth, c2w = scene["ds"][idx]
    i = rng.integers(0, mopts.W, n).astype(np.float32)
    j = rng.integers(0, mopts.H, n).astype(np.float32)
    d = depth[j.astype(int), i.astype(int)].copy()
    d[rng.uniform(size=n) < hole_share] = 0.0
    ro, rd = jcam.rays_from_uv(jnp.asarray(i), jnp.asarray(j),
                               jnp.asarray(c2w), mopts.fx, mopts.fy,
                               mopts.cx, mopts.cy)
    return np.array(ro), np.array(rd), d.astype(np.float32)


@pytest.mark.parametrize("far", [2.5, "device"])
def test_probe_z_vals_bit_equal_to_jax(scene, far):
    s, mo = scene["state"], scene["mopts_map"]
    ro, rd, _ = frame_rays(scene, 4, 300, seed=1)
    # rays that leave the room's map: most probes find nothing there
    rd[:40] = -rd[:40]
    far_v = 2.5 if far == 2.5 else jnp.float32(3.1)
    jz, jinv = jpc.sample_near_pcl_z_vals(s, mo, jnp.asarray(ro),
                                          jnp.asarray(rd), 0.3, far_v, 5)
    ts = port_map(s)
    tz, tinv = tpc.sample_near_pcl_z_vals(
        ts, tpc.MapOptions.from_cfg(scene["cfg"]), t(ro), t(rd), 0.3,
        2.5 if far == 2.5 else torch.tensor(3.1), 5)
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    inv = tinv.numpy()
    assert 0.05 < inv.mean() < 0.95  # both outcomes occur
    # valid rays sample between two probe depths inside [near, far]
    z = tz.numpy()[~inv]
    assert (np.diff(z, axis=1) > 0).all() and (z[:, 0] >= 0.3).all()


@pytest.mark.parametrize("bf16", [False, True])
def test_render_batch_ray_near_pcl_matches(scene, bf16):
    jdec.set_bf16_trunks(bf16)
    try:
        s, params = scene["state"], scene["params"]
        ropts = scene["ropts"]
        assert ropts.sample_near_pcl
        ro, rd, d = frame_rays(scene, 4, 200, seed=2)
        key = jax.random.PRNGKey(5)
        kg, kc = jax.random.split(key)
        n = 200 * ropts.n_surface
        noise = [np.asarray(jax.random.normal(kg, (n, 32))),
                 np.asarray(jax.random.normal(kc, (n, 32)))]
        jout = jrend.render_batch_ray(
            params, s.pos, s.grid, s.feat, jnp.asarray(ro), jnp.asarray(rd),
            jnp.asarray(d), jnp.asarray(d > 0), key, ropts, "color")
        ts = port_map(s)
        dec = decoders_from_numpy(to_np(params), "cpu", bf16_trunks=bf16)
        with torch.no_grad():
            tout = trend.render_batch_ray(
                dec, ts.pos, ts.grid, ts.feat, t(ro), t(rd), t(d), t(d > 0),
                ReplayDraws(noise, "cpu"), port_render_options(ropts),
                "color")
    finally:
        jdec.set_bf16_trunks(True)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    tol = TOL[bf16]
    for a, b in zip(tout[:3], jout[:3]):
        assert_close_scaled(a.numpy(), b, tol["rtol"], tol["atol"])
    # hole rays whose probe found the surface render a depth and count as
    # valid; without the option they would render 0
    hole_valid = (d == 0) & tout[3].numpy()
    assert hole_valid.sum() > 5
    assert (tout[0].numpy()[hole_valid] > 0.3).all()


def _tiny_session_cfg(tmp, name, **over):
    cfg = small_cfg(**over)
    cfg["data"]["output"] = str(tmp / name)
    cfg["model"]["bf16_trunks"] = False
    cfg["verbose"] = False
    cfg["rendering"]["sample_near_pcl"] = True
    cfg["mapping"].update({"segment_strategy": "none", "vis_freq": 0})
    cfg["tracking"]["vis_freq"] = 0
    return cfg


# a half-size camera (30x40) renders the map in 3 chunks of 512 rays, the
# last one padded, at a fraction of a 60x80 frame's cost (JAX's k-NN runs
# its kernel in interpret mode on the CPU)
HALF_CAM = {"H": 30, "W": 40, "fx": 30.0, "fy": 30.0, "cx": 19.75,
            "cy": 14.75}
CHUNK = 512


def test_render_img_of_a_frame_with_holes(scene, tmp_path):
    """The port's chunked render_img against the JAX session's, on the
    same converted map: the last chunk is padded with zero-depth rays,
    which must not set the probe's far."""
    jcfg = _tiny_session_cfg(tmp_path, "jax", cam=HALF_CAM)
    jdec.set_bf16_trunks(False)
    js = jslam_mod.LoopySLAM(jcfg, output=jcfg["data"]["output"])
    try:
        js.map_state = scene["state"]
        js.params = scene["params"]
        _, _, depth, c2w = scene["ds"][4]
        depth = depth[::2, ::2].copy()
        depth[5:15, 10:25] = 0.0  # a hole
        depth[::4, ::3] = 0.0
        keys = [jax.random.PRNGKey(k) for k in (10, 11, 12)]
        it = iter(keys)
        js._next_key = lambda: next(it)
        jd, jc = js.render_img(c2w, depth, chunk=CHUNK)
    finally:
        jdec.set_bf16_trunks(True)
    n = CHUNK * js.ropts_mapper.n_surface
    draws = []
    for k in keys:
        kg, kc = jax.random.split(k)
        draws += [np.asarray(jax.random.normal(kg, (n, 32))),
                  np.asarray(jax.random.normal(kc, (n, 32)))]
    ps = LoopySLAM(_tiny_session_cfg(tmp_path, "port", cam=HALF_CAM),
                   device="cpu")
    try:
        ps.dec = decoders_from_numpy(to_np(scene["params"]), "cpu",
                                     bf16_trunks=False)
        ps.map_state = port_map(scene["state"])
        ps.draw = ReplayDraws(draws, "cpu")
        pd, pc = ps.render_img(c2w, depth, chunk=CHUNK)
    finally:
        ps.close()
    assert not ps.draw.items
    assert_close_scaled(pd, jd, 1e-4, 1e-6)
    assert_close_scaled(pc, jc, 1e-4, 1e-6)
    holes = depth == 0
    assert (np.isfinite(pd[holes]) & (pd[holes] > 0)).mean() > 0.5


# ---------------------------------------------------------------------------
# bundle adjustment
# ---------------------------------------------------------------------------

def ba_draws(key, F, ppf, S, c, H, W, n_geo, n_col):
    """JAX's draws inside _optimize_map_impl's unpooled path (BA builds no
    pool), in the port's order: per iteration the window's rows (F, ppf)
    and cols (F, ppf), then the decode's geometry (and color) noise."""
    out = []
    k = key
    for it in range(n_geo + n_col):
        k, kiter = jax.random.split(k)
        ks, kr = jax.random.split(kiter)
        fkeys = jax.random.split(ks, F)
        js, is_ = [], []
        for f in range(F):
            kh, kw = jax.random.split(fkeys[f])
            js.append(jax.random.randint(kh, (ppf,), 0, H))
            is_.append(jax.random.randint(kw, (ppf,), 0, W))
        kg, kc = jax.random.split(kr)
        out += [jnp.stack(js), jnp.stack(is_),
                jax.random.normal(kg, (F * ppf * S, c))]
        if it >= n_geo:
            out.append(jax.random.normal(kc, (F * ppf * S, c)))
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("case", ["poses", "map"])
def test_ba_mapping_call_matches_jax(scene, case):
    """One optimize_map call with the window's poses trainable, against
    JAX's: the oldest row fixed by its mask, the others moving only in
    their iteration window of the session's count, which this call
    (iter_offset 2, 3 geometry + 1 color iterations) enters at its second
    iteration ([3, 5), case "poses") or its last ([5, 6), case "map");
    sample_near_pcl on, so every iteration probes."""
    cfg, ds = scene["cfg"], scene["ds"]
    mopts, ropts = scene["mopts"], scene["ropts"]
    frames = [ds[i] for i in (0, 2, 4)]
    kc = np.stack([f[1] for f in frames])
    kd = np.stack([f[2] for f in frames])
    kp = np.stack([f[3] for f in frames]).astype(np.float32)
    # the poses BA should correct; off the insertion poses too, where a
    # sample can fall exactly on a point and its distance's gradient has
    # no direction
    kp[:, :3, 3] += np.asarray([[0.003, -0.002, 0.001], [0.004, 0.004, 0.0],
                                [-0.004, 0.002, 0.004]], np.float32)
    cams = np.stack([np.asarray(jcam.tensor_from_c2w(p)) for p in kp])
    mask = [0.0, 1.0, 1.0]
    s, params = scene["state"], scene["params"]
    feat_mask = np.asarray(jpc.valid_mask(s))
    ppf, n_geo, n_col, S = 60, 3, 1, ropts.n_surface
    if case == "poses":
        lrs_geo, lrs_col = [0.0] * 3, [0.0] * 3
        window = (3.0, 5.0)
    else:
        lrs_geo, lrs_col = [0.001, 0.03, 0.0], [0.005, 0.005, 0.005]
        window = (5.0, 6.0)
    ba_lr, offset = 1e-3, 2
    key = jax.random.PRNGKey(8)
    jdec.set_bf16_trunks(False)
    try:
        trainable = jax.tree.map(jnp.copy, {"dec": params, "feat": s.feat,
                                            "cams": jnp.asarray(cams)})
        jt, jst, jaux = jmapper.optimize_map(
            trainable, jadam.init(trainable),
            jdec.trainable_mask(params, cfg), jnp.asarray(feat_mask), s.pos,
            s.grid, jnp.asarray(kc), jnp.asarray(kd), jnp.asarray(kp), None,
            key, jnp.asarray(n_geo), jnp.asarray(n_col),
            jnp.asarray(lrs_geo), jnp.asarray(lrs_col), mopts, ropts, ppf,
            False, ba_row_mask=jnp.asarray(mask, jnp.float32),
            ba_lr=jnp.asarray(ba_lr, jnp.float32),
            ba_window=jnp.asarray(window, jnp.float32),
            iter_offset=jnp.asarray(offset, jnp.int32))
    finally:
        jdec.set_bf16_trunks(True)
    draws = ba_draws(key, 3, ppf, S, ropts.c_dim, mopts.H, mopts.W, n_geo,
                     n_col)
    ts = port_map(s)
    dec = decoders_from_numpy(to_np(params), "cpu", bf16_trunks=False)
    rd = ReplayDraws(draws, "cpu")
    feat, tst, taux, tcams = tmapper.optimize_map(
        dec, ts.feat, None, t_mask(dec, cfg), t(feat_mask), ts.pos, ts.grid,
        t(kc), t(kd), t(kp), rd, n_geo, n_col, lrs_geo, lrs_col,
        tmapper.MapperOptions(**{k: v for k, v in mopts._asdict().items()
                                 if k in tmapper.MapperOptions._fields}),
        port_render_options(ropts), ppf, cams=t(cams), ba_row_mask=mask,
        ba_lr=ba_lr, ba_window=window, iter_offset=offset)
    assert not rd.items
    ja = [float(a) for a in jaux]
    ta = [float(a) for a in taux]
    assert ta[2] == ja[2] > 0
    jc = np.asarray(jt["cams"])
    tc = tcams.numpy()
    np.testing.assert_array_equal(tc[0], cams[0])  # the masked row
    # the poses' Adam moments moved on every iteration, the masked row too
    assert np.abs(tst.m[-1][0].numpy()).max() > 0
    if case == "poses":
        np.testing.assert_allclose(ta[:2], ja[:2], rtol=1e-4)
        np.testing.assert_allclose(tc, jc, atol=2e-6)
        assert np.abs(jc[1:] - cams[1:]).max() > 1.5e-3  # two steps
        assert_close_scaled(tst.m[-1].numpy(), jst.m["cams"], 1e-3, 1e-2)
        return
    np.testing.assert_allclose(ta[:2], ja[:2], rtol=1e-3)
    assert np.abs(tc - jc).max() <= 2 * ba_lr + 1e-7
    assert np.abs(jc[1:] - cams[1:]).max() > 5e-4  # one step
    jp = dict(leaves_with_names(to_np(jt["dec"])))
    pairs = [(feat.numpy(), np.asarray(jt["feat"]),
              n_geo * lrs_geo[1] + n_col * lrs_col[1])]
    pairs += [(p.detach().numpy(), jp[n], n_geo * lrs_geo[0]
               + n_col * lrs_col[0]) for n, p in dec.named_parameters()]
    for a, b, lr_sum in pairs:
        assert np.abs(a - b).max() <= 2 * lr_sum + 1e-6
    # the color stage's restart leaves the poses' leaf going on
    st2 = tmapper.start_color_stage(tst, dec, feat.shape[1] // 2,
                                    with_cams=True)
    assert torch.equal(st2.m[-1], tst.m[-1]) and st2.start[-1] == 0
    assert not torch.equal(st2.m[-2], tst.m[-2])  # the features' color half


def _session_pair(tmp_path, n_kf, monkeypatch):
    """A JAX and a port session of the tiny synthetic room with BA on and
    n_kf keyframes (frames 0..n_kf-1 at perturbed poses), and both
    packages' optimize_map replaced by a stand-in that records its BA
    arguments and sets the window's poses to fixed targets (the poses
    plus 1 mm a row in x) without optimizing. Returns (jax session, port
    session, jax calls, port calls, targets)."""
    over = {"mapping": {"BA": True, "BA_cam_lr": 0.001, "keyframe_every": 1,
                        "every_frame": 1, "mapping_window_size": 8,
                        "segment_strategy": "fixed",
                        "fixed_segment_size": 1000,
                        # num fixed at 2 x iters whatever the insertion adds
                        "min_iter_ratio": 2.0, "iters": 40}}
    jcfg = _tiny_session_cfg(tmp_path, "jax", **over)
    jcfg["mapping"]["segment_strategy"] = "fixed"
    tcfg = _tiny_session_cfg(tmp_path, "port", **over)
    tcfg["mapping"]["segment_strategy"] = "fixed"
    js = jslam_mod.LoopySLAM(jcfg, output=jcfg["data"]["output"])
    ps = LoopySLAM(tcfg, device="cpu")
    targets = {}
    jcalls, tcalls = [], []

    def target(cams):
        key = cams.tobytes()
        if key not in targets:
            tgt = cams.copy()
            tgt[:, 4] += 0.001 * np.arange(1, len(cams) + 1)
            targets[key] = tgt
        return targets[key]

    def jspy(trainable, st, *args, **kw):
        rec = {k: (None if v is None else np.asarray(v))
               for k, v in kw.items()}
        rec["g"], rec["c"] = int(args[9]), int(args[10])
        rec["cams"] = (np.asarray(trainable["cams"])
                       if "cams" in trainable else None)
        jcalls.append(rec)
        if "cams" in trainable:
            trainable = {**trainable,
                         "cams": jnp.asarray(target(rec["cams"]))}
        return trainable, st, (jnp.zeros(()),) * 3

    real = tmapper.optimize_map

    def tspy(dec, feat, st, dec_mask, feat_mask, pos, grid, kc, kd, kp, draw,
             g, c, *args, **kw):
        rec = {k: v for k, v in kw.items() if k.startswith(("ba_", "iter"))}
        rec["g"], rec["c"] = g, c
        rec["cams"] = None if kw.get("cams") is None else kw["cams"].numpy()
        tcalls.append(rec)
        out = real(dec, feat, st, dec_mask, feat_mask, pos, grid, kc, kd, kp,
                   draw, 0, 0, *args, **kw)
        if rec["cams"] is not None:
            out = out[:-1] + (torch.as_tensor(target(rec["cams"])),)
        return out

    monkeypatch.setattr(jmapper, "optimize_map", jspy)
    monkeypatch.setattr(tmapper, "optimize_map", tspy)
    ds = ps.dataset
    rng = np.random.default_rng(0)
    for i in range(n_kf + 1):
        _, c, d, p = ds[i]
        pose = p.copy()
        pose[:3, 3] += rng.normal(scale=0.003, size=3).astype(np.float32)
        for sess, up in ((js, lambda c, d: jslam_mod._upload_frame(c, d)),
                         (ps, lambda c, d: slam_upload(c, d))):
            sess.estimate_c2w[i] = pose
            sess.gt_c2w[i] = p
            if i < n_kf:
                color, depth = up(c, d)
                sess._add_keyframe(i, color, depth, pose, p)
                sess.keyframe_list.append(i)
                sess.keyframe_global_list.append(i)
                sess.prev_mapped_idx = i
    return js, ps, jcalls, tcalls


def slam_upload(c, d):
    from loopy_slam_torch.slam import _upload_frame

    return _upload_frame(c, d, "cpu")


def _map_both(js, ps, idx, color_refine=False):
    _, c, d, p = ps.dataset[idx]
    jcol, jdep = jslam_mod._upload_frame(c, d)
    js.map_frame(idx, jcol, jdep, p, c, depth_np=d, color_refine=color_refine)
    tcol, tdep = slam_upload(c, d)
    ps.map_frame(idx, tcol, tdep, p, d, c, color_refine=color_refine)


@pytest.mark.parametrize("n_kf", [6, 4])
def test_session_ba_window_mask_and_write_back(tmp_path, monkeypatch, n_kf):
    """map_frame of both packages on the same keyframes: BA trains the
    same poses (the oldest keyframe and the repeats of the padded window
    fixed) over the same iteration window, in the port as one call per
    stage with the session's iteration count carried across, and writes
    the same poses back into the keyframes' and the current frame's
    estimates. With 4 keyframes, and in color refinement, BA stays off."""
    js, ps, jcalls, tcalls = _session_pair(tmp_path, n_kf, monkeypatch)
    try:
        _map_both(js, ps, n_kf)
        if n_kf <= 4:
            assert all(r["cams"] is None for r in jcalls + tcalls)
            assert ps.ba_frames == []
            return
        assert ps.ba_frames == [n_kf]
        jr = jcalls[0]
        np.testing.assert_array_equal(tcalls[0]["cams"], jr["cams"])
        for r in tcalls:
            np.testing.assert_array_equal(
                np.asarray(r["ba_row_mask"], np.float32), jr["ba_row_mask"])
            np.testing.assert_array_equal(
                np.asarray(r["ba_window"], np.float32), jr["ba_window"])
        mask = jr["ba_row_mask"]
        assert (mask == 0).any() and mask.sum() >= 2
        # both carry the session's iteration count across their calls
        for calls in (jcalls, tcalls):
            done = 0
            for r in calls:
                assert int(r["iter_offset"]) == done
                done += r["g"] + r["c"]
            assert done == 80
        np.testing.assert_allclose(ps.estimate_c2w[n_kf],
                                   js.estimate_c2w[n_kf], atol=1e-7)
        assert np.abs(ps.estimate_c2w[n_kf]
                      - ps.gt_c2w[n_kf]).max() > 0  # written back
        moved = 0
        for i in range(n_kf):
            np.testing.assert_allclose(ps.kf_est_c2w[i], js.kf_est_c2w[i],
                                       atol=1e-7)
            moved += np.abs(ps.kf_est_c2w[i] - ps.estimate_c2w[i]).max() \
                > 1e-4
        assert moved >= 2
        # the oldest keyframe stays where it was
        np.testing.assert_array_equal(ps.kf_est_c2w[0], ps.estimate_c2w[0])
        # color refinement over the merged map: no BA
        jcalls.clear()
        tcalls.clear()
        _map_both(js, ps, n_kf, color_refine=True)
        assert jcalls and tcalls
        assert all(r["cams"] is None for r in jcalls + tcalls)
        assert ps.ba_frames == [n_kf]
    finally:
        ps.close()


# ---------------------------------------------------------------------------
# a tiny session with the three options
# ---------------------------------------------------------------------------

FRAMES, SCALE, SPEED = 16, 4, 1.0 / 200.0
ATE_GATE_M = 0.06
# freiburg1_desk.yaml with the three options, at the JAX package's budgets
# for its own session with sample_near_pcl on this fixture
# (tests/test_sensor_fixtures.py: 200 x 12 tracking, 400 x 30 mapping),
# without the dynamic radius (its 64-slot rows make every probe's plain
# k-NN on the CPU 4x dearer) and without submaps (a segment restarts the
# local keyframes, so BA, which needs more than 4, would never start);
# keyframe_every 2 puts a fifth keyframe in the window by frame 10
SESSION = {
    "use_dynamic_radius": False,
    "rendering": {"sample_near_pcl": True},
    "tracking": {"pixels": 200, "iters": 12, "ignore_edge_W": 4,
                 "ignore_edge_H": 4, "vis_freq": 0,
                 "visual_odometer": True, "const_speed_assumption": False},
    "mapping": {"pixels": 400, "pixels_adding": 800,
                "pixels_based_on_color_grad": 50, "iters": 20,
                "iters_first": 60, "geo_iter_first": 20,
                "mapping_window_size": 4, "keyframe_every": 2,
                "every_frame": 2, "BA": True, "color_refine": False,
                "segment_strategy": "none", "vis_freq": 0},
    "pointcloud": {"capacity": 2 ** 15, "cell_table_size": 2 ** 16,
                   "max_per_cell": 24},
    "meshing": {"eval_rec": False},
    "verbose": False,
}


def test_tiny_tum_session_with_the_three_options(tmp_path):
    import json

    seq = str(tmp_path / "seq")
    tfix.main(["--out", seq, "--frames", str(FRAMES), "--scale", str(SCALE),
               "--motion-speed", str(SPEED)])
    cam = tfix.scale_cam(tfix.TUM_CAM, SCALE)
    over = dict(SESSION)
    over["cam"] = {**{k: cam[k] for k in ("H", "W", "fx", "fy", "cx", "cy")},
                   "crop_edge": 2}
    out = str(tmp_path / "out")
    over["data"] = {"input_folder": seq, "output": out}
    path = str(tmp_path / "tum.yaml")
    with open(path, "w") as f:
        f.write("inherit_from: " + json.dumps(os.path.join(
            ROOT, "configs", "TUM_RGBD", "freiburg1_desk.yaml")) + "\n")
        for k, v in over.items():
            f.write(f"{k}: {json.dumps(v)}\n")
    cfg = tload(path)
    assert cfg["rendering"]["sample_near_pcl"] and cfg["mapping"]["BA"]
    stats = trun.main([path, "--device", "cpu"])
    assert stats["n"] >= 8
    assert stats["rmse"] < ATE_GATE_M, stats
    assert stats["health_rejects"] == 0
    # the odometer ran on every tracked frame from frame 2 on
    assert len(stats["timings_s"]["odometry"]) == stats["n"] - 2
    assert stats["ba_frames"], stats["n"]
    # the final checkpoint carries the keyframe poses BA moved
    ck = load_checkpoint(trun.latest_checkpoint(out))
    est = np.asarray(ck["estimate_c2w_list"])
    moved = [i for i, p in ck["keyframe_est_c2w"].items()
             if np.linalg.norm(p[:3, 3] - est[i][:3, 3]) > 1e-7]
    assert moved
