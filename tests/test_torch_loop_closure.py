"""Parity of the port's loop-closure modules with the JAX package, on the
CPU: Lie maps, the LM pose-graph solve, the copied registration and
fragment bookkeeping, place recognition's matcher and vote, and a whole
compute_correction round; plus the port's import hygiene.

Tolerances: the pose-graph nodes and line-process weights within 1e-4
(both packages solve in float32, the JAX one on a graph padded to powers
of two, so the LU solves round differently); registration transforms,
matcher scores and votes bit-equal (the same numpy/scipy code, the same
integer arithmetic); compute_correction's corrections within 1e-4 (the
float32 solve).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loopy_slam_torch.mapping import fragments as tfrag
from loopy_slam_torch.mapping import loop_closure as tlc
from loopy_slam_torch.mapping import place_recognition as tpr
from loopy_slam_torch.ops import lie as tlie
from loopy_slam_torch.ops import pose_graph as tpg
from loopy_slam_torch.ops import registration as treg
from loopy_slam_tpu.mapping import fragments as jfrag
from loopy_slam_tpu.mapping import loop_closure as jlc
from loopy_slam_tpu.mapping import place_recognition as jpr
from loopy_slam_tpu.native.build import HammingIndex
from loopy_slam_tpu.ops import lie as jlie
from loopy_slam_tpu.ops import pose_graph as jpg
from loopy_slam_tpu.ops import registration as jreg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# Lie maps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-7, 1e-3, 0.1, 0.5])
def test_se3_exp_log_match_jax_and_round_trip(scale):
    xi = np.random.default_rng(0).normal(size=(20, 6)).astype(np.float32) \
        * scale
    T = tlie.se3_exp(_t(xi))
    np.testing.assert_allclose(T.numpy(), np.asarray(
        jlie.se3_exp(jnp.asarray(xi))), atol=1e-6)
    np.testing.assert_allclose(tlie.se3_log(T).numpy(), xi,
                               atol=max(1e-4 * scale, 1e-6))
    np.testing.assert_allclose((T @ tlie.se3_inv(T)).numpy(),
                               np.tile(np.eye(4), (20, 1, 1)), atol=1e-5)


def test_so3_exp_has_finite_gradient_at_zero():
    phi = torch.zeros(3, requires_grad=True)
    tlie.so3_exp(phi).sum().backward()
    assert torch.isfinite(phi.grad).all()


# ---------------------------------------------------------------------------
# Pose graph (the graphs of tests/test_lie_pose_graph.py)
# ---------------------------------------------------------------------------

def _trajectory(rng, n):
    poses = [np.eye(4)]
    for _ in range(n - 1):
        xi = np.concatenate([rng.normal(size=3) * 0.1,
                             rng.normal(size=3) * 0.05])
        poses.append(poses[-1] @ np.asarray(jlie.se3_exp(jnp.asarray(xi))))
    return np.stack(poses).astype(np.float32)


def _drift_graph(rng):
    n = 12
    gt = _trajectory(rng, n)
    zs = []
    for i in range(n - 1):
        z = np.linalg.inv(gt[i]) @ gt[i + 1]
        noise = np.concatenate([rng.normal(size=3) * 0.02,
                                rng.normal(size=3) * 0.01])
        zs.append(z @ np.asarray(jlie.se3_exp(jnp.asarray(noise))))
    nodes = [np.eye(4, dtype=np.float32)]
    for z in zs:
        nodes.append((nodes[-1] @ z).astype(np.float32))
    ei = list(range(n - 1)) + [0, 3, 0]
    ej = list(range(1, n)) + [n - 1, n - 2, n // 2]
    z_all = zs + [np.linalg.inv(gt[0]) @ gt[n - 1],
                  np.linalg.inv(gt[3]) @ gt[n - 2],
                  np.linalg.inv(gt[0]) @ gt[n // 2]]
    info = np.tile(np.eye(6, dtype=np.float32), (len(ei), 1, 1))
    info[n - 1:] *= 50.0
    certain = np.array([True] * (n - 1) + [False, False, False])
    return (np.stack(nodes), np.array(ei), np.array(ej),
            np.stack(z_all).astype(np.float32), info, certain, 40)


def _bad_loop_graph(rng):
    n = 8
    gt = _trajectory(rng, n)
    ei, ej, z, info = jpg.build_odometry_chain(gt)
    bad = np.eye(4)
    bad[:3, 3] = [1.5, -1.0, 0.8]
    ei = np.concatenate([ei, [0]])
    ej = np.concatenate([ej, [n - 1]])
    z = np.concatenate([z, bad[None]]).astype(np.float32)
    info = (np.concatenate([info, np.eye(6)[None]]) * 100.0).astype(
        np.float32)
    certain = np.array([True] * (n - 1) + [False])
    return gt, ei, ej, z, info, certain, 30


@pytest.mark.parametrize("make", [_drift_graph, _bad_loop_graph])
def test_optimize_matches_jax(make):
    nodes, ei, ej, z, info, certain, iters = make(np.random.default_rng(0))
    jn, jw = jpg.optimize(jpg.PoseGraph(
        jnp.asarray(nodes), jnp.asarray(ei, jnp.int32),
        jnp.asarray(ej, jnp.int32), jnp.asarray(z), jnp.asarray(info),
        jnp.asarray(certain)), preference_loop_closure=5.0,
        max_iters=iters)
    tn, tw = tpg.optimize(tpg.PoseGraph(
        _t(nodes), torch.as_tensor(ei).long(), torch.as_tensor(ej).long(),
        _t(z), _t(info), torch.as_tensor(certain)),
        preference_loop_closure=5.0, max_iters=iters)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-4)
    if make is _bad_loop_graph:  # the wrong loop edge is pruned in both
        assert float(tw[-1]) < 0.25 and float(np.asarray(jw)[-1]) < 0.25
    else:  # the valid loop edges survive in both
        assert float(tw[-2:].min()) > 0.25


def test_edge_residuals_zero_on_a_consistent_graph():
    gt = _trajectory(np.random.default_rng(1), 6)
    ei, ej, z, info = tpg.build_odometry_chain(gt)
    g = tpg.PoseGraph(_t(gt), torch.as_tensor(ei).long(),
                      torch.as_tensor(ej).long(), _t(z), _t(info),
                      torch.ones(len(ei), dtype=torch.bool))
    assert tpg.edge_residuals(_t(gt), g).abs().max() < 1e-4


# ---------------------------------------------------------------------------
# Registration (the cases of tests/test_registration.py)
# ---------------------------------------------------------------------------

def _surface(rng, n):
    x = rng.uniform(-1, 1, n)
    z = rng.uniform(-1, 1, n)
    y = (0.3 * np.sin(2.5 * x) + 0.2 * np.cos(3.1 * z)
         + 0.1 * np.sin(5 * x * z))
    return np.stack([x, y, z], -1)


def _rigid(rng, rot, tr):
    T = np.eye(4)
    T[:3, :3] = jreg._rotvec_to_mat(rng.normal(size=3) * rot)
    T[:3, 3] = rng.normal(size=3) * tr
    return T


def _pair(src, dst, kf_dst=np.eye(4)):
    return ({"points": src, "points_color": np.zeros_like(src),
             "keyframe": np.eye(4)},
            {"points": dst, "points_color": np.zeros_like(dst),
             "keyframe": kf_dst})


def _case_large_offset(rng):
    src = _surface(rng, 5000)
    T = _rigid(rng, 0.4, 0.5)
    return _pair(src, src @ T[:3, :3].T + T[:3, 3], T), 20000, 0.999, 3


def _case_nonoverlapping(rng):
    src = _surface(rng, 2000)
    dst = _surface(np.random.default_rng(99), 2000) + np.array([10, 0, 0])
    return _pair(src, dst), 5000, 0.99, 4


def _case_small_drift(rng):
    src = _surface(rng, 4000)
    T = _rigid(rng, 0.01, 0.02)
    return _pair(src, src @ T[:3, :3].T + T[:3, 3]), 20000, 0.999, 7


@pytest.mark.parametrize("case", [_case_large_offset, _case_nonoverlapping,
                                  _case_small_drift])
def test_registration_copy_is_bit_equal(case):
    (s, t), iters, conf, seed = case(np.random.default_rng(0))
    outs = [mod.register_point_cloud_pair(
        0, 2, s, t, method="robust_icp", global_iter=iters, conf=conf,
        rng=np.random.default_rng(seed)) for mod in (jreg, treg)]
    assert outs[0]["success"] == outs[1]["success"]
    for key in ("transformation", "information"):
        np.testing.assert_array_equal(outs[0][key], outs[1][key])


def test_colored_icp_copy_is_bit_equal():
    rng = np.random.default_rng(0)
    pts = _surface(rng, 3000)
    colors = np.repeat((0.5 + 0.3 * np.sin(7 * pts[:, 0]))[:, None], 3, 1)
    T = _rigid(rng, 0.01, 0.015)
    kf = np.eye(4)
    kf[:3, 3] = [0, 2.0, 0]
    src = {"points": pts @ T[:3, :3].T + T[:3, 3], "points_color": colors,
           "keyframe": kf}
    dst = {"points": pts, "points_color": colors, "keyframe": kf}
    a = jreg.pairwise_registration(src, dst, method="colored_icp")
    b = treg.pairwise_registration(src, dst, method="colored_icp")
    np.testing.assert_array_equal(a["transformation"], b["transformation"])


# ---------------------------------------------------------------------------
# Fragments (the cases of tests/test_fragments_lc.py)
# ---------------------------------------------------------------------------

def _fm(mod):
    return mod.FragmentManager(0.3, 0.94, 60, 80, 60.0, 60.0, 39.5, 29.5)


def test_segment_trigger_matches_jax():
    rng = np.random.default_rng(0)
    img, dep = np.zeros((60, 80, 3)), np.zeros((60, 80))
    fms = [_fm(jfrag), _fm(tfrag)]
    for fm in fms:
        fm.start_fragment(0, np.eye(4), np.eye(4), img, dep, None)
    for _ in range(50):
        c2w = np.eye(4)
        c2w[:3, :3] = jreg._rotvec_to_mat(rng.normal(size=3) * 0.3)
        c2w[:3, 3] = rng.normal(size=3) * 0.3
        assert fms[0].should_start_new(c2w) == fms[1].should_start_new(c2w)
        pts = rng.normal(size=(200, 3)) * 2
        np.testing.assert_array_equal(fms[0].carry_over_mask(c2w, pts),
                                      fms[1].carry_over_mask(c2w, pts))


def test_merged_global_matches_jax():
    rng = np.random.default_rng(0)
    img, dep = np.zeros((60, 80, 3)), np.zeros((60, 80))
    fms = [_fm(jfrag), _fm(tfrag)]
    prev_carry = 0
    arrays = []
    for i in range(4):
        n = 50 + 10 * i
        p, g = rng.normal(size=(n, 3)), rng.normal(size=(n, 4))
        carry = rng.uniform(size=n) < 0.3
        arrays.append((p, g, g * 2, carry, prev_carry))
        prev_carry = int(carry.sum()) if i < 3 else 0
    outs = []
    for fm in fms:
        for i, (p, g, c, carry, idx0) in enumerate(arrays[:-1]):
            fm.start_fragment(i, np.eye(4), np.eye(4), img, dep, None,
                              idx_start_features=idx0)
            fm.close_active(p, g, c, p, p, carry)
        p, g, c, _, idx0 = arrays[-1]
        fm.start_fragment(9, np.eye(4), np.eye(4), img, dep, None,
                          idx_start_features=idx0)
        outs.append(fm.merged_global(p, g, c))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Place recognition
# ---------------------------------------------------------------------------

def _cv2_descriptors(n_images=6):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    out = []
    for i in range(n_images):
        base = rng.uniform(0, 1, (12 + i, 16 + i))
        img = cv2.resize(base, (320, 240), interpolation=cv2.INTER_CUBIC)
        img = np.clip(img * 255, 0, 255).astype(np.uint8)
        _, des = cv2.ORB_create().detectAndCompute(img, None)
        out.append(des)
    # a revisit of image 1: the same texture with ~8% of the bits flipped
    noisy = out[1].copy()
    flip = rng.uniform(size=noisy.shape + (8,)) < 0.08
    noisy ^= np.packbits(flip, axis=-1, bitorder="little")[..., 0]
    out.append(noisy)
    return out


def test_match_score_is_bit_equal_to_jax():
    des = _cv2_descriptors()
    for a in des:
        for b in des:
            assert tpr.match_score(a, b, device="cpu") == \
                jpr.match_score(a, b)
    assert tpr.match_score(None, des[0], device="cpu") == 0.0
    assert tpr.baseline_score(des[1], des[2:], device="cpu") == \
        jpr.baseline_score(des[1], des[2:])


def test_index_votes_and_query_are_bit_equal_to_jax():
    des = _cv2_descriptors()
    rng = np.random.default_rng(5)
    stored = des[:6] + [None] + [rng.integers(0, 256, (120, 32), np.uint8)
                                 for _ in range(24)]
    tdb, jdb = tpr.ScoreDB(device="cpu"), jpr.ScoreDB()
    if jdb._index is None:  # as tests/test_place_recognition_index.py
        pytest.skip("the JAX package's native index did not build")
    native = HammingIndex()
    for i, d in enumerate(stored):
        tdb.add(d)
        jdb.add(d)
        if d is not None:
            native.add(d, i)
    q = des[-1]
    np.testing.assert_array_equal(tdb.query_votes(q, len(stored)),
                                  native.query_votes(q, len(stored)))
    assert tdb.query(q, 3) == jdb.query(q, 3)  # past the 24-anchor shortlist
    assert tdb.query(q, 3)[0].Id == 1


# ---------------------------------------------------------------------------
# A whole correction round (the drift case of tests/test_fragments_lc.py)
# ---------------------------------------------------------------------------

def _box_cloud(rng, n=3000):
    w = rng.integers(0, 3, n)
    u, v = rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)
    pts = np.zeros((n, 3))
    pts[w == 0] = np.stack([u[w == 0], v[w == 0],
                            -np.ones((w == 0).sum())], -1)
    pts[w == 1] = np.stack([np.ones((w == 1).sum()), u[w == 1], v[w == 1]],
                           -1)
    pts[w == 2] = np.stack([u[w == 2], np.ones((w == 2).sum()), v[w == 2]],
                           -1)
    return pts + 0.05 * np.sin(3 * pts[:, [1, 2, 0]])


def _closer(fmod, lmod, prmod, cloud, **kw):
    fm = _fm(fmod)
    lc = lmod.LoopCloser(lmod.LoopClosureConfig(
        n_jobs=1, global_iter=20000, conf=0.999, orb_filter=False,
        min_dist=1, kval=3, std_threshold=1.0), fm, **kw)
    img, dep = np.zeros((60, 80, 3)), np.zeros((60, 80))
    drift = np.eye(4)
    drift[:3, 3] = [0.12, -0.08, 0.1]
    for i in range(5):
        anchor = np.eye(4)
        anchor[:3, 3] = [0.05 * i, 0, 0]
        fm.start_fragment(i * 10, anchor, anchor, img, dep, None)
        lc.dbow_scores.append(-1.0)
        f = fm.fragments[-1]
        f.npc = cloud.copy()
        f.geo = f.col = np.zeros((len(cloud), 2))
        f.carry_mask = np.zeros(len(cloud), bool)
        T = drift if i >= 3 else np.eye(4)
        f.reg_points = cloud @ T[:3, :3].T + T[:3, 3]
        f.reg_colors = np.zeros_like(cloud)
        f.sensor_pts, f.sensor_rgb = f.reg_points, np.zeros_like(cloud)

    class FakeDB:  # every anchor matches fragment 0 (and 3)
        def query(self, des, k):
            return [prmod.QueryResult(0, 1.0), prmod.QueryResult(3, 0.9)]
    lc.db = FakeDB()
    return lc


def test_compute_correction_matches_jax():
    cloud = _box_cloud(np.random.default_rng(0))
    jl = _closer(jfrag, jlc, jpr, cloud)
    tl = _closer(tfrag, tlc, tpr, cloud, device="cpu")
    jc, tc = jl.compute_correction(), tl.compute_correction()
    assert jc is not None and tc is not None
    edges = lambda lc: [(e["s"], e["t"], e["accepted"])  # noqa: E731
                        for e in lc.last_diag]
    assert edges(tl) == edges(jl)
    np.testing.assert_allclose(tc, jc, atol=1e-4)
    np.testing.assert_allclose(tc[3][:3, 3], [-0.12, 0.08, -0.1], atol=0.03)
    assert tl.rounds[-1]["solved"] and tl.rounds[-1]["applied"]


# ---------------------------------------------------------------------------
# Import hygiene
# ---------------------------------------------------------------------------

def test_port_imports_with_jax_and_cv2_blocked():
    """Every module of the port and chip_smoke import with jax, the JAX
    package and cv2 made unimportable (None in sys.modules)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'loopy_slam_tpu', 'cv2'):\n"
        "    sys.modules[m] = None\n"
        "import pkgutil, importlib\n"
        "import loopy_slam_torch\n"
        "for m in pkgutil.walk_packages(loopy_slam_torch.__path__,"
        " 'loopy_slam_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, \
        proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# Device defaults
# ---------------------------------------------------------------------------

def _entry_points():
    from loopy_slam_torch import convert
    from loopy_slam_torch.config import DEFAULTS
    from loopy_slam_torch.mapping import point_cloud
    from loopy_slam_torch.models import decoder
    from loopy_slam_torch.ops import draws
    from loopy_slam_torch.ops import orb
    from loopy_slam_torch.ops import tsdf
    from loopy_slam_torch.tools.get_mesh_tsdf_fusion import mesh_from_renders
    from loopy_slam_torch.utils import lpips

    des = np.zeros((4, 32), np.uint8)
    frame = (np.zeros((8, 8, 3), np.float32), np.ones((8, 8), np.float32))
    cam = {"fx": 8.0, "fy": 8.0, "cx": 3.5, "cy": 3.5}
    npz = os.path.join(ROOT, "pretrained", "lpips_alex_randfeat.npz")
    return {
        "decoders_from_numpy": lambda: convert.decoders_from_numpy({}),
        "map_state_from_numpy": lambda: convert.map_state_from_numpy(
            np.zeros((4, 3)), np.zeros((4, 64)), 0, np.zeros((2, 4, 4)),
            np.zeros(2), 0.1, 0),
        "init_decoders": lambda: decoder.init_decoders(torch.Generator(),
                                                       DEFAULTS),
        "init_map": lambda: point_cloud.init_map(
            point_cloud.MapOptions.from_cfg(DEFAULTS), capacity=16),
        "ReplayDraws": lambda: draws.ReplayDraws([]),
        "load_lpips": lambda: lpips.load_lpips(npz),
        "mesh_from_renders": lambda: mesh_from_renders([frame], [np.eye(4)],
                                                       cam, voxel=0.5),
        "init_grid": lambda: tsdf.init_grid([0, 0, 0], (2, 2, 2), 0.1),
        "grid_for_bounds": lambda: tsdf.grid_for_bounds([0, 0, 0],
                                                        [1, 1, 1], 0.5),
        "fuse_frames": lambda: tsdf.fuse_frames([frame], [np.eye(4)], 8.0,
                                                8.0, 3.5, 3.5, voxel=0.5),
        "ScoreDB": lambda: tpr.ScoreDB(),
        "match_score": lambda: tpr.match_score(des, des),
        "baseline_score": lambda: tpr.baseline_score(des, [des]),
        "LoopCloser": lambda: tlc.LoopCloser(tlc.LoopClosureConfig(),
                                             _fm(tfrag)),
        "extract_orb": lambda: orb.extract_orb(frame[0]),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_point_defaults_to_the_card(name, monkeypatch):
    """Left without a device, an entry point asks for the card and raises
    when there is none, rather than running on the host."""
    make = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
