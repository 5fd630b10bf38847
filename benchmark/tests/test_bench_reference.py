"""The plain reference (benchmark/reference/) against the program at tiny
sizes on the CPU: the decoders, compositing, a tracking iteration's loss
and pose gradient, Adam, and the brute-force k-NN against the program's
grid k-NN. The reference imports nothing of the program; these tests
import both.
"""

import ast
import os

import numpy as np
import pytest
import torch

import tiny
from reference import knn as ref_knn
from reference import render as ref

from loopy_slam_torch.config import DEFAULTS
from loopy_slam_torch.models.decoder import (col_forward, geo_forward,
                                             init_decoders,
                                             neighbor_transform)
from loopy_slam_torch.ops import adam, knn
from loopy_slam_torch.ops.compositing import composite


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


def test_reference_imports_nothing_of_the_program():
    """The reference imports the standard library, numpy and torch, and of
    the benchmark only its own scene and sequence writer (the frames it
    wrote), which in turn import nothing of the program."""
    own = {"bench_core.scene": "scene.py", "bench_core.sequence":
           "sequence.py"}
    for name in os.listdir(os.path.join(tiny.BENCH, "reference")):
        if not name.endswith(".py"):
            continue
        for m in _imports(os.path.join(tiny.BENCH, "reference", name)):
            assert m in own or m.split(".")[0] in (
                "__future__", "math", "typing", "numpy", "torch"), (name, m)
    for name in ("scene.py", "sequence.py", "images.py"):
        for m in _imports(os.path.join(tiny.BENCH, "bench_core", name)):
            assert m in (".images", ".scene") or m.split(".")[0] in (
                "__future__", "ctypes", "hashlib", "multiprocessing", "os",
                "shutil", "struct", "subprocess", "tempfile", "threading",
                "typing", "zlib", "numpy", "scipy"), (name, m)


def _dec(seed=0):
    g = torch.Generator().manual_seed(seed)
    dec = init_decoders(g, DEFAULTS, "cpu")
    return dec, {n: p.detach().clone() for n, p in dec.named_parameters()}


def test_decoders_and_compositing_equal_programs():
    dec, P = _dec()
    g = torch.Generator().manual_seed(1)
    p = torch.rand(50, 3, generator=g) * 4 - 2
    c = torch.randn(50, 32, generator=g)
    torch.testing.assert_close(ref.geo_forward(P, p, c, torch.float32),
                               geo_forward(dec.geo, p, c), rtol=0, atol=0)
    torch.testing.assert_close(ref.col_forward(P, p, c, torch.float32),
                               col_forward(dec.col, p, c), rtol=0, atol=0)
    f = torch.randn(50, 8, 32, generator=g)
    rel = torch.randn(50, 8, 3, generator=g) * 0.05
    torch.testing.assert_close(
        ref.neighbor_transform(P, f, rel, torch.float32),
        neighbor_transform(dec.col, f, rel), rtol=0, atol=0)
    rgb = torch.rand(20, 5, 3, generator=g)
    occ = torch.randn(20, 5, generator=g) * 30
    z = torch.sort(torch.rand(20, 5, generator=g) * 3, -1).values
    ours = ref.composite(rgb, occ, z, 0.1)
    theirs = composite(rgb, occ, z, 0.1)
    for a, b in zip(ours, (theirs[0], theirs[1], theirs[2])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_adam_equals_programs():
    g = torch.Generator().manual_seed(2)
    ps = [torch.randn(7, generator=g), torch.randn(30, 4, generator=g)]
    gs = [torch.randn(7, generator=g), None]
    st = adam.init(ps)
    for _ in range(3):
        new_p, st2 = adam.update(ps, gs, st, [0.01, torch.full((4,), 0.1)])
        ours = ref.adam_step(ps, gs, st.m, st.v, st.step, st.start,
                             [0.01, torch.full((4,), 0.1)])
        for a, b in zip(ours, new_p):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        ps, st = new_p, st2
    st = adam.restart(st, [None, torch.tensor([True, False, True, False])])
    new_p, _ = adam.update(ps, [gs[0], torch.ones(30, 4)], st, 0.05)
    ours = ref.adam_step(ps, [gs[0], torch.ones(30, 4)], st.m, st.v,
                         st.step, st.start, [0.05, 0.05])
    for a, b in zip(ours, new_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("per_query", [False, True])
def test_brute_force_knn_agrees_with_programs(per_query):
    g = torch.Generator().manual_seed(3)
    pts = torch.rand(4000, 3, generator=g)
    q = torch.rand(500, 3, generator=g)
    grid = knn.build(pts, torch.ones(4000, dtype=torch.bool), 0.1, 4096, 64)
    r = (torch.rand(500, generator=g) * 0.05 + 0.05) if per_query else 0.08
    D, I, nn = knn.query(grid, pts, q, 8, r)
    slot = torch.arange(8)[None]
    prog = torch.where(slot < nn[:, None].long(), I.long(), -1)
    r2 = torch.as_tensor(r, dtype=torch.float64) ** 2
    truth = ref_knn.nearest(pts, q, 8, r2)
    gap = ref_knn.set_gap(pts, q, prog, truth, r2)
    # the program's packed key keeps 12 bits of a distance's mantissa, so
    # a near tie (or a neighbour at the radius) may swap: 2**-12 of r^2
    assert float(gap.max()) < 2.0 ** -12
    low = ref_knn.nearest(pts.bfloat16(), q.bfloat16(), 8, r2,
                          dt=torch.bfloat16)
    assert float(ref_knn.set_gap(pts, q, low, truth, r2).max()) > 1e-3


def test_track_loss_equals_programs():
    """One cached tracking iteration of the program, its loss and pose
    gradient, against the reference on the same pool rows and draws."""
    from loopy_slam_torch.mapping import tracker
    from loopy_slam_torch.models.renderer import RenderOptions, gather_featpos
    from loopy_slam_torch.ops.draws import ReplayDraws

    dec, P = _dec(4)
    g = torch.Generator().manual_seed(5)
    N, R, S, k = 3000, 64, 5, 8
    pos = torch.rand(N, 3, generator=g) * 0.6 + torch.tensor([0., 0., -2.3])
    feats = torch.randn(N, 64, generator=g) * 0.1
    grid = knn.build(pos, torch.ones(N, dtype=torch.bool), 0.16, 8192, 64)
    opts = tracker.TrackOptions(pixels=R, H=40, W=60, fx=50.0, fy=50.0,
                                cx=29.5, cy=19.5)
    ropts = RenderOptions()
    P_ = 2 * R
    i = torch.randint(0, 60, (P_,), generator=g).float()
    j = torch.randint(0, 40, (P_,), generator=g).float()
    d = 2.0 + torch.rand(P_, generator=g) * 0.3
    c = torch.rand(P_, 3, generator=g)
    cam7 = torch.tensor([1.0, 0.01, -0.02, 0.0, 0.3, 0.3, 0.0])
    inside = torch.ones(P_, dtype=torch.bool)
    z = d[:, None] * torch.linspace(0.98, 1.02, S)[None]
    ro, rd = ref.rays(i, j, cam7, 50.0, 50.0, 29.5, 19.5)
    pts = (ro[:, None] + rd[:, None] * z[..., None]).reshape(-1, 3)
    D, I, nn = knn.query(grid, pos, pts, k, 0.08)
    cache = {"i": i, "j": j, "d": d, "c": c, "inside": inside, "z": z,
             "rq": None, "D": D.reshape(P_, S * k),
             "both": gather_featpos(feats, pos, I).reshape(P_, S * k, -1),
             "nn": nn.reshape(P_, S)}
    pick = np.random.default_rng(0).integers(0, P_, R)
    noises = [np.random.default_rng(s).standard_normal((R * S, 32))
              .astype(np.float32) for s in (1, 2)]
    draws = ReplayDraws([pick] + noises, "cpu")
    cam = cam7.clone().requires_grad_(True)
    loss, _ = tracker.tracking_loss_cached(cam, dec, cache, draws, opts,
                                           ropts)
    (grad,) = torch.autograd.grad(loss, [cam])
    pk = torch.as_tensor(pick)
    rec = {"opts": {"fx": 50.0, "fy": 50.0, "cx": 29.5, "cy": 19.5,
                    "handle_dynamic": True, "w_color_loss": 0.5,
                    "use_color_in_tracking": True},
           "ropts": {"radius_query": 0.08, "nn_num": k, "min_nn_num": 2,
                     "weighting": "distance", "encode_rel_pos_in_col": True,
                     "sigmoid_coef": 0.1, "n_surface": S},
           "cam7": cam7, "params": P, "i": i[pk], "j": j[pk], "d": d[pk],
           "c": c[pk], "inside": inside[pk], "z": z[pk], "rq": None,
           "pos": pos, "feats": feats,
           "I": I.reshape(P_, S * k)[pk].reshape(-1, k),
           "empty": ~(D.reshape(P_, S * k)[pk].reshape(-1, k) < 1e9),
           "nn": nn.reshape(P_, S)[pk].reshape(-1),
           "noises": [torch.as_tensor(n) for n in noises]}
    L, G = ref.track_loss(rec)
    torch.testing.assert_close(L, loss.detach(), rtol=1e-6, atol=0)
    torch.testing.assert_close(G, grad, rtol=1e-5, atol=1e-7)
    Lc, Gc = ref.track_loss(rec, torch.bfloat16)
    assert abs(float(Lc) - float(L)) / float(L) > 1e-3


def test_reference_frames_are_what_the_programs_loader_reads(tmp_path):
    """A tiny TUM recording (fr1's distortion, dropped depth frames, holes,
    jittered stamps): the reference's association picks the files the
    program's loader picks, its depth equals the loaded depth, and its
    undistorted colour lies within cv2's fixed-point rounding of it
    (measured: a mean of 0.27 levels, at most 3.2)."""
    import copy

    from bench_core.harness import load_cell, update_recursive
    from bench_core.sequence import write_sequence
    from reference import frames as ref_frames

    from loopy_slam_torch.utils.datasets import get_dataset

    c = load_cell("tum-fr1-desk.steady")
    cfg = copy.deepcopy(c["config"]["resolved"])
    update_recursive(cfg, tiny.overrides("tum-fr1-desk"))
    t = c["traffic"]
    seq = t["sequences"][1]
    write_sequence(cfg["dataset"], str(tmp_path), cfg["cam"], t["frames"],
                   t["motion_speed"], seq["phase"], seq["sensor_seed"],
                   t["scene"], t["sensor"], workers=1)
    cfg["data"]["input_folder"] = str(tmp_path)
    ds = get_dataset(cfg)
    rec = ref_frames.Recording(cfg["dataset"], cfg["cam"], t, 1)
    assert len(rec.pairs) == len(ds) < t["frames"]
    for idx in range(len(ds)):
        a, b = rec.pairs[idx]
        assert ds.color_paths[idx].endswith(rec.plan[a]["rgb_name"])
        assert ds.depth_paths[idx].endswith(rec.plan[b]["depth_name"])
        _, color, depth, _ = ds[idx]
        j, i = np.mgrid[0:depth.shape[0], 0:depth.shape[1]]
        i, j = i.ravel(), j.ravel()
        np.testing.assert_allclose(depth.ravel(), rec.depth(idx, i, j),
                                   rtol=1e-6, atol=0)
        # cv2 rounds its map to 1/32 of a pixel and its weights to 1/2^15;
        # at 48x64 an edge spans tens of levels a pixel
        gap = np.abs(color.reshape(-1, 3) * 255.0 - rec.color(idx, i, j))
        assert gap.mean() < 0.5 and gap.max() <= 5.0, (idx, gap.max())
