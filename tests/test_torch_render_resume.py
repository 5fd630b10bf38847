"""Full-frame rendering, restore/resume, the visualizer and the final
evaluation of the port's LoopySLAM, on the CPU, in tiny sessions (60x80,
5 frames, at the verify skill's size).

Tolerances:
  * render_img of a JAX map with JAX's noise draws replayed: 1e-4
    relative with f32 trunks (as tests/test_torch_decoder_renderer.py
    holds the renderer: float32 on both sides, summation order and libm's
    last bit amplified by Fourier phases);
  * stop-then-resume against the same session run straight through: poses
    within 1e-4 and the same map count. The resumed session rebuilds its
    index with build_adaptive where the straight one grew it by insertion,
    and the k-NN's neighbour sets do not depend on the slot order, so the
    two are expected to agree to the last bit; the band leaves room for a
    reduction that sums in another order;
  * a JAX-written checkpoint restored by the port: map, poses and keyframe
    bookkeeping equal; the keyframe pixels re-read through the same
    uint8/uint16 quantization within 1e-7.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loopy_slam_torch import run as trun
from loopy_slam_torch.config import load_config as tload
from loopy_slam_torch.convert import decoders_from_numpy, map_state_from_numpy
from loopy_slam_torch.ops.draws import ReplayDraws
from loopy_slam_torch.slam import LoopySLAM
from loopy_slam_torch.utils.imageio import read_jpeg
from loopy_slam_torch.utils.io import load_checkpoint
from loopy_slam_torch.utils.visualizer import Visualizer
from loopy_slam_tpu import slam as jslam_mod
from loopy_slam_tpu.config import load_config as jload
from loopy_slam_tpu.mapping import mapper as jmapper
from loopy_slam_tpu.models import decoder as jdec
from loopy_slam_tpu.tools import eval_images as jimages
from loopy_slam_tpu.tools import eval_recon as jrecon
from torch_cpu import cpu_settings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOM = os.path.join(ROOT, "configs", "Synthetic", "room.yaml")
N_FRAMES, STOP, VIS = 5, 2, 4

TINY = """inherit_from: "{room}"
data: {{n_frames: {n}, output: "{out}"}}
cam: {{H: 60, W: 80, fx: 60.0, fy: 60.0, cx: 39.5, cy: 29.5}}
model: {{bf16_trunks: False}}
tracking: {{pixels: 200, iters: 12, ignore_edge_W: 4, ignore_edge_H: 4,
  vis_freq: {vis}}}
mapping: {{every_frame: 2, pixels: 400, pixels_adding: 800, iters: 30,
  iters_first: 60, geo_iter_first: 20, mapping_window_size: 4,
  keyframe_every: 2, color_refine: False, segment_strategy: none,
  vis_freq: {vis}}}
pointcloud: {{capacity: 32768, cell_table_size: 65536, radius_add: 0.08,
  radius_query: 0.16, radius_min: 0.04}}
"""


def _tiny(tmp, name):
    out = tmp / name
    path = tmp / f"{name}.yaml"
    path.write_text(TINY.format(room=ROOM, n=N_FRAMES, out=out, vis=VIS))
    return str(path), out


def assert_close_scaled(a, b, rtol, floor):
    """|a - b| <= rtol * |b| + floor * max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=floor * scale)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """The tiny session run straight through (LoopySLAM.run), and the same
    session through the CLI: --stop 2, then --resume with the final
    evaluation."""
    tmp = tmp_path_factory.mktemp("render_resume")
    with cpu_settings():
        cfg_path, out_s = _tiny(tmp, "straight")
        slam = LoopySLAM(tload(cfg_path), device="cpu")
        try:
            straight = slam.run()
        finally:
            slam.close()
        cli_path, out_c = _tiny(tmp, "cli")
        stopped = trun.main([cli_path, "--device", "cpu", "--stop",
                             str(STOP)])
        resumed = trun.main([cli_path, "--device", "cpu", "--resume"])
    return dict(straight=straight, slam=slam, out_c=out_c, stopped=stopped,
                resumed=resumed)


def test_stop_then_resume_matches_the_straight_run(sessions):
    r = sessions["resumed"]
    assert sessions["stopped"]["n"] == STOP + 1
    assert r["resume"]["start_idx"] == STOP + 1
    assert r["resume"]["checkpoint"].endswith(f"{STOP:05d}.pkl")
    ck_stop = load_checkpoint(r["resume"]["checkpoint"])
    assert r["resume"]["points"] == ck_stop["map"]["count"]
    ck = load_checkpoint(str(sessions["out_c"] / "ckpts"
                             / f"{N_FRAMES - 1:05d}.pkl"))
    straight = sessions["straight"]
    np.testing.assert_allclose(ck["estimate_c2w_list"],
                               straight["estimate_c2w"], atol=1e-4)
    assert ck["map"]["count"] == straight["n_points"] == r["n_points"]
    assert r["n"] == N_FRAMES and r["rmse"] < 0.02


def _jax_eval_keys():
    """The keys of the JAX package's final_eval: its render metrics and
    its 3-D and 2-D reconstruction metrics, from tiny inputs."""
    img = np.full((24, 24, 3), 0.5, np.float32)
    d = np.ones((24, 24), np.float32)
    keys = set(jimages.evaluate_renders([(img, img, d, d)]))
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0.1]], float)
    f = np.array([[0, 1, 2], [1, 3, 2]])
    keys |= set(jrecon.calc_3d_metric((v, f), (v, f), n_samples=200,
                                      align=False))
    keys |= set(jrecon.calc_2d_metric((v, f), (v, f), n_views=1,
                                      align=False))
    return keys


def test_cli_resume_returns_the_final_evaluation(sessions):
    r, out = sessions["resumed"], sessions["out_c"]
    assert "eval_error" not in r
    assert "psnr" not in sessions["stopped"]  # a stopped run skips it
    keys = _jax_eval_keys()
    assert keys <= set(r), keys - set(r)
    for k in keys:
        assert np.isfinite(r[k]), (k, r[k])
    assert r["psnr"] > 12 and r["accuracy"] < 15
    assert (out / "mesh" / "final_mesh.ply").stat().st_size > 1000
    n_eval = len(range(0, N_FRAMES, 2))
    assert r["n_frames"] == n_eval
    for i in range(0, N_FRAMES, 2):
        for kind in ("color", "depth"):
            assert (out / "rendered_every_frame"
                    / f"{kind}_{i:05d}.npy").exists()
    assert set(r["eval_timings_s"]) >= {"render_s", "mesh_s", "metric_3d_s",
                                        "metric_2d_s"}


def test_visualizer_pngs_decode_to_six_panels(sessions):
    out = sessions["out_c"]
    # frame 4, in the resumed run: tracked (12 iterations) and mapped (30)
    names = {d: sorted(os.listdir(out / d))
             for d in ("tracking_vis", "mapping_vis")}
    assert names == {"tracking_vis": ["00004_0011.jpg"],
                     "mapping_vis": ["00004_0029.jpg"]}
    for name in ("tracking_vis/00004_0011.jpg", "mapping_vis/00004_0029.jpg"):
        img = read_jpeg(str(out / name))
        assert img.shape == (2 * 60, 3 * 80, 3)
        assert img.std() > 10  # not a blank image
    vis = sessions["resumed"]["timings_s"]["vis"]
    assert len(vis) == 2 and min(vis) > 0


def test_vis_value_only_is_render_img(sessions, tmp_path):
    """The visualizer's render is the session's render_img, bit for bit,
    from the same draw state."""
    slam = sessions["slam"]
    idx = N_FRAMES - 1
    _, _, depth, _ = slam.dataset[idx]
    c2w = slam.estimate_c2w[idx]
    state = slam.draw.gen.get_state()
    want = slam.render_img(c2w, depth)
    slam.draw.gen.set_state(state)
    got = Visualizer(1, str(tmp_path), slam).vis_value_only(c2w, depth)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert np.abs(want[0]).max() > 0  # a rendered frame, not blank


# ---------------------------------------------------------------------------
# a map and a checkpoint written by the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_session(tmp_path_factory):
    """A JAX LoopySLAM holding a map inserted from frames 0 and 2 (no
    optimization), two keyframes, and its checkpoint at frame 2."""
    tmp = tmp_path_factory.mktemp("jax_ckpt")
    cfg_path, out = _tiny(tmp, "jax")
    cfg = jload(cfg_path)
    js = jslam_mod.LoopySLAM(cfg, output=str(out))
    try:
        state, prev = js.map_state, None
        for i, key in ((0, 1), (2, 2)):
            _, c, d, p = js.dataset[i]
            state, _ = jmapper.add_points_from_frame(
                state, jnp.asarray(c), jnp.asarray(d), jnp.asarray(p),
                jnp.asarray(p if prev is None else prev),
                jax.random.PRNGKey(key), js.mopts_map, js.mopts, 800,
                overlap=None)
            prev = p
            js.estimate_c2w[i] = js.gt_c2w[i] = p
            js.estimate_c2w[i + 1] = js.gt_c2w[i + 1] = js.dataset[i + 1][3]
            color, depth = jslam_mod._upload_frame(c, d)
            js._add_keyframe(i, color, depth, p, p)
            js.keyframe_list.append(i)
            js.keyframe_global_list.append(i)
        js.map_state = state
        js.prev_mapped_idx = 2
        js.finalize(2, final=False)
        _, _, d, p = js.dataset[3]
        render = _jax_render(js, p, d, [jax.random.PRNGKey(10),
                                        jax.random.PRNGKey(11)])
        yield js, str(out / "ckpts" / "00002.pkl"), cfg_path, (p, d, render)
    finally:
        jdec.set_bf16_trunks(True)  # the JAX package's process-wide default


def _jax_render(js, c2w, depth, keys):
    """JAX's render_img with the chunk keys given, and the noise draws the
    port must replay to match it (geometry then color, per chunk)."""
    it = iter(keys)
    js._next_key = lambda: next(it)
    d, c = js.render_img(c2w, depth)
    draws = []
    n = 4096 * js.ropts_mapper.n_surface
    for k in keys:
        kg, kc = jax.random.split(k)
        draws += [np.asarray(jax.random.normal(kg, (n, 32))),
                  np.asarray(jax.random.normal(kc, (n, 32)))]
    return d, c, draws


def _port_session(tmp_path, cfg_path):
    return LoopySLAM(tload(cfg_path), output=str(tmp_path / "port"),
                     device="cpu")


def test_render_img_of_a_converted_jax_map(jax_session, tmp_path):
    js, _, cfg_path, (p, d, (jd, jc, draws)) = jax_session
    s = js.map_state
    g = s.grid
    with cpu_settings():
        ps = _port_session(tmp_path, cfg_path)
        try:
            ps.dec = decoders_from_numpy(jax.tree.map(np.asarray, js.params),
                                         "cpu", bf16_trunks=False)
            ps.map_state = map_state_from_numpy(
                np.asarray(s.pos), np.asarray(s.feat), np.asarray(s.count),
                np.asarray(g.cell_data), np.asarray(g.cell_fill),
                np.asarray(g.cell_size), np.asarray(g.n_dropped),
                device="cpu")
            ps.draw = ReplayDraws(draws, "cpu")
            pd, pc = ps.render_img(p, d)
        finally:
            ps.close()
    assert not ps.draw.items  # every replayed draw was used
    assert (jd > 0).mean() > 0.5
    assert_close_scaled(pd, jd, 1e-4, 1e-6)
    assert_close_scaled(pc, jc, 1e-4, 1e-6)


def test_jax_checkpoint_restores_in_the_port(jax_session, tmp_path):
    js, ckpt_path, cfg_path, (p, d, (jd, jc, draws)) = jax_session
    with cpu_settings():
        ps = _port_session(tmp_path, cfg_path)
        try:
            before = ps.draw.gen.get_state()
            assert ps.restore(ckpt_path) == 3
            n = int(js.map_state.count)
            ms = ps.map_state
            assert int(ms.count) == n > 500 and int(ms.grid.n_dropped) == 0
            np.testing.assert_array_equal(ms.pos[:n].numpy(),
                                          np.asarray(js.map_state.pos)[:n])
            np.testing.assert_array_equal(ms.feat[:n].numpy(),
                                          np.asarray(js.map_state.feat)[:n])
            np.testing.assert_array_equal(ps.estimate_c2w[:3],
                                          js.estimate_c2w[:3])
            assert ps.keyframe_list == js.keyframe_list == [0, 2]
            assert ps.keyframe_global_list == [0, 2]
            assert ps.kf_slot_of_idx == js.kf_slot_of_idx
            np.testing.assert_allclose(ps.kf_color[:2].numpy(),
                                       np.asarray(js.kf_color)[:2],
                                       atol=1e-7)
            np.testing.assert_allclose(ps.kf_depth[:2].numpy(),
                                       np.asarray(js.kf_depth)[:2],
                                       atol=1e-7)
            assert ps.prev_mapped_idx == 2
            # a JAX key cannot continue a torch generator: the port keeps
            # its own, seeded from setup_seed
            assert torch.equal(ps.draw.gen.get_state(), before)
            ps.draw = ReplayDraws(draws, "cpu")
            pd, pc = ps.render_img(p, d)
        finally:
            ps.close()
    assert_close_scaled(pd, jd, 1e-4, 1e-6)
    assert_close_scaled(pc, jc, 1e-4, 1e-6)
