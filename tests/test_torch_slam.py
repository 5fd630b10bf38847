"""The port's slice end to end on the CPU, its entry points' import hygiene,
its config checks, and chip_smoke.py's config dict."""

import copy
import os
import subprocess
import sys

import pytest

from loopy_slam_torch.config import DEFAULTS, update_recursive
from loopy_slam_torch.slam import check_slice
from loopy_slam_torch.tools.eval_ate import evaluate_from_output
from loopy_slam_torch.utils.io import load_checkpoint
from loopy_slam_tpu.config import load_config as jax_load_config
from torch_cpu import torch_cpu  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOM = os.path.join(ROOT, "configs", "Synthetic", "room.yaml")

# the tiny session of .claude/skills/verify/SKILL.md, on the port's slice
TINY = """inherit_from: {room}
data: {{n_frames: 8, output: {out}}}
cam: {{H: 60, W: 80, fx: 60.0, fy: 60.0, cx: 39.5, cy: 29.5}}
tracking: {{pixels: 200, iters: 12, ignore_edge_W: 4, ignore_edge_H: 4,
  vis_freq: 0}}
mapping: {{every_frame: 2, pixels: 400, pixels_adding: 800, iters: 30,
  iters_first: 60, geo_iter_first: 20, mapping_window_size: 4,
  keyframe_every: 2, color_refine: False, segment_strategy: none,
  vis_freq: 0}}
pointcloud: {{capacity: 32768, cell_table_size: 65536, radius_add: 0.08,
  radius_query: 0.16, radius_min: 0.04}}
"""


def test_cli_tiny_session_on_cpu(tmp_path, capsys, torch_cpu):
    from loopy_slam_torch import run

    out = tmp_path / "out"
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY.format(room=ROOM, out=out))
    stats = run.main([str(cfg_path), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "ATE RMSE (aligned, m):" in printed
    assert "final eval:" in printed  # the room's eval_rec runs
    assert stats["rmse"] < 0.02 and stats["n"] == 8
    assert stats["psnr"] > 12 and stats["accuracy"] < 15
    assert (out / "mesh" / "final_mesh.ply").stat().st_size > 200
    assert (out / "final_point_cloud.ply").stat().st_size > 200
    ck = load_checkpoint(str(out / "ckpts" / "00007.pkl"))
    for key in ("estimate_c2w_list", "gt_c2w_list", "idx", "params", "map",
                "keyframe_list", "keyframe_est_c2w", "selected_keyframes",
                "cfg", "resume"):
        assert key in ck
    assert ck["map"]["pos"].shape == (ck["map"]["count"], 3)
    assert ck["params"]["geo"]["lin"][0]["w"].shape == (93, 32)
    assert evaluate_from_output(str(out))["rmse"] == pytest.approx(
        stats["rmse"])


def test_port_imports_no_jax_cv2_or_yaml():
    """Importing every port module and chip_smoke leaves jax, the JAX
    package, cv2 and yaml out of sys.modules (fresh interpreter)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import loopy_slam_torch\n"
        "for m in pkgutil.walk_packages(loopy_slam_torch.__path__,"
        " 'loopy_slam_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'loopy_slam_tpu', 'cv2', 'yaml')]\n"
        "print(sorted(bad))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_config_equals_room_yaml():
    sys.path.insert(0, ROOT)
    import chip_smoke

    got = chip_smoke.room_config(31, "somewhere")
    want = jax_load_config(ROOM)
    update_recursive(want, copy.deepcopy(chip_smoke.SLICE_OVERRIDES))
    want["data"]["n_frames"] = 31
    want["data"]["output"] = "somewhere"
    assert got == want
    assert got["mapping"]["segment_strategy"] == "none"


@pytest.mark.parametrize("name", [
    "group_16", "group_32", "match_every_query", "reduce_min_merge",
    "no_scan", "no_scan_no_merge", "empty"])
def test_chip_smoke_variants_edit_the_kernel_source(name):
    """Each edit of `chip_smoke.py --variants` matches knn_select.cu exactly
    once, so the variants keep tracking the kernel they are timed beside."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    assert name in chip_smoke.VARIANTS and len(chip_smoke.VARIANTS) == 7
    with open(os.path.join(ROOT, "loopy_slam_torch", "csrc",
                           "knn_select.cu")) as f:
        src = f.read()
    assert chip_smoke.variant_source(src, name) != src


def test_chip_smoke_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _slice_cfg(**over):
    cfg = copy.deepcopy(DEFAULTS)
    update_recursive(cfg, {"mapping": {"segment_strategy": "none",
                                       "color_refine": False, "vis_freq": 0},
                           "tracking": {"vis_freq": 0}})
    update_recursive(cfg, over)
    return cfg


# ROADMAP.md Queue 1 items the port has: their settings pass check_slice
PORTED_ITEMS = {10, 14, 15, 16}


@pytest.mark.parametrize("over,item", [
    ({"mapping": {"segment_strategy": "rot_trans"}}, 10),
    ({"mapping": {"color_refine": True}}, 10),
    ({"tracking": {"visual_odometer": True}}, 11),
    ({"parallel": {"n_devices": 4}}, 13),
    ({"tracking": {"vis_freq": 5}}, 14),
    ({"use_dynamic_radius": True}, 15),
    ({"tracking": {"sample_with_color_grad": True}}, 15),
    ({"mapping": {"pixels_based_on_color_grad": 100}}, 15),
    ({"model": {"encode_exposure": True}}, 16),
    ({"mapping": {"BA": True}}, 17),
    ({"rendering": {"sample_near_pcl": True}}, 18),
    ({"wandb": True}, 19),
])
def test_features_outside_the_slice_raise(over, item):
    """A feature of a ROADMAP item not yet ported raises, naming the item;
    the settings of ported items (submaps, loop closure and color
    refinement: item 10; the visualizer: item 14; the dynamic radius and
    the color-gradient picks: item 15; exposure compensation: item 16)
    pass."""
    cfg = _slice_cfg(use_dynamic_radius=False,
                     rendering={"sample_near_pcl": False})
    check_slice(cfg)  # the slice's own settings pass
    update_recursive(cfg, over)
    if item in PORTED_ITEMS:
        check_slice(cfg)
        return
    with pytest.raises(NotImplementedError, match=f"item {item}\\)"):
        check_slice(cfg)


def test_visualizer_that_never_fires_is_accepted():
    """The shipped vis_freq of 50 passes, whether or not it fires within
    the run: the visualizer is ported (item 14), so check_slice no longer
    needs the run's length."""
    cfg = _slice_cfg(use_dynamic_radius=False,
                     rendering={"sample_near_pcl": False},
                     tracking={"vis_freq": 50}, mapping={"vis_freq": 50})
    check_slice(cfg)


def test_color_stage_starts_its_leaves_afresh(tmp_path, monkeypatch,
                                              torch_cpu):
    """The session's mapping frames never mix the stages in one
    optimize_map call, thread the Adam state within each stage, start each
    frame's geometry stage with no state, and hand the color stage the
    geometry stage's state with the color leaves (the color decoder, the
    features' color half) started afresh and the geometry leaves going on
    (mapper.start_color_stage)."""
    from loopy_slam_torch.config import load_config
    from loopy_slam_torch.mapping import mapper
    from loopy_slam_torch.slam import LoopySLAM

    calls = []
    optimize_map = mapper.optimize_map

    def spy(dec, feat, st, dec_mask, feat_mask, pos, grid, kc, kd, kp, draw,
            g, c, *args, **kw):
        names = [n for n, _ in dec.named_parameters()]
        calls.append((g, c, st, names, feat.shape[1] // 2))
        out = optimize_map(dec, feat, st, dec_mask, feat_mask, pos, grid,
                           kc, kd, kp, draw, g, c, *args, **kw)
        calls[-1] += (out[1],)
        return out

    monkeypatch.setattr(mapper, "optimize_map", spy)
    cfg = load_config(ROOM)
    update_recursive(cfg, {
        "verbose": False,
        "data": {"n_frames": 3},
        "cam": {"H": 60, "W": 80, "fx": 60.0, "fy": 60.0, "cx": 39.5,
                "cy": 29.5},
        "tracking": {"pixels": 200, "iters": 4, "ignore_edge_W": 4,
                     "ignore_edge_H": 4, "vis_freq": 0},
        "mapping": {"every_frame": 2, "pixels": 400, "pixels_adding": 800,
                    "iters": 30, "iters_first": 60, "geo_iter_first": 20,
                    "mapping_window_size": 4, "keyframe_every": 2,
                    "color_refine": False, "segment_strategy": "none",
                    "vis_freq": 0, "device_chunk_iters": 16},
        "pointcloud": {"capacity": 32768, "cell_table_size": 65536},
    })
    slam = LoopySLAM(cfg, output=str(tmp_path), device="cpu")
    try:
        slam.run()
    finally:
        slam.close()
    # frame 0: 21 geometry iterations (16 + 5), 39 color (16 + 16 + 7)
    assert [(g, c) for g, c, *_ in calls[:5]] == [
        (16, 0), (5, 0), (0, 16), (0, 16), (0, 7)]
    stages = ["geometry" if g else "color" for g, *_ in calls]
    assert stages[5] == "geometry" and "color" in stages[5:]  # frame 2
    for i, (g, c, st, names, half, st_out) in enumerate(calls):
        assert bool(g) != bool(c) and g + c <= 16
        if stages[i] == "geometry":
            # a frame's first geometry chunk starts with no state
            assert (st is None) == (i == 0 or stages[i - 1] == "color")
            continue
        assert st is not None
        if stages[i - 1] == "color":  # threaded within the stage
            assert st is calls[i - 1][5]
            continue
        prev = calls[i - 1][5]
        assert st.step == prev.step
        n = len(names)
        for k, name in enumerate(names):
            if name.startswith("col."):
                assert st.start[k] == st.step
                assert not st.m[k].any() and not st.v[k].any()
            else:
                assert st.start[k] == 0 and st.m[k] is prev.m[k]
        cols = st.start[n]
        assert (cols[half:] == st.step).all() and (cols[:half] == 0).all()
        assert not st.m[n][:, half:].any()
        assert st.m[n][:, :half].equal(prev.m[n][:, :half])
