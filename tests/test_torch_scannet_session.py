"""A tiny session with exposure compensation on the JAX fixture script's
ScanNet sequence (tests/test_sensor_fixtures.py's 16 frames at scale 4,
1296x968 JPEG color over 640x480 depth, a per-frame exposure gain and
tint, one inf ground-truth pose), through the port's CLI on the CPU, with
scannet.yaml (exposure, the dynamic radius, the gradient pool) and that
test's scale-4 camera.

Tolerances: ATE below 6 cm, the JAX package's own band for its session on
this fixture; a finite non-zero exposure latent; one color-decoder
snapshot per mapped frame. With tests/test_sensor_fixtures.py's budgets
(200 tracking pixels x 12 iterations) both packages end 9-10 cm off on
this sequence (4.7 cm and 2 degrees a frame; the JAX session 8.8 cm);
with 400 x 30 and a denser map both stay inside the band (2.4 cm each).
The comparison with the JAX session on the same overlay is marked slow
(JAX's session is compile-bound, ~7 minutes): both below 6 cm and within
3 cm of each other (end-to-end runs differ in random streams).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from loopy_slam_torch import run as trun
from loopy_slam_torch.config import load_config as tload
from loopy_slam_torch.utils.io import load_checkpoint
from loopy_slam_tpu.config import load_config as jload
from torch_cpu import cpu_settings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, SCALE, SPEED = 16, 4, 1.0 / 60
ATE_GATE_M = 0.06
SESSION = {
    "tracking": {"pixels": 400, "iters": 30, "ignore_edge_W": 4,
                 "ignore_edge_H": 4, "vis_freq": 0},
    "mapping": {"pixels": 800, "pixels_adding": 1500,
                "pixels_based_on_color_grad": 50, "iters": 30,
                "iters_first": 100, "geo_iter_first": 30,
                "mapping_window_size": 4, "keyframe_every": 2,
                "color_refine": False, "save_rendered_image": False,
                "vis_freq": 0},
    "pointcloud": {"capacity": 2 ** 15, "cell_table_size": 2 ** 16,
                   "max_per_cell": 24},
    "meshing": {"eval_rec": False},
    "verbose": False,
}


@pytest.fixture(scope="module")
def scannet_session(tmp_path_factory):
    """The port's session on the JAX script's ScanNet fixture
    (tests/test_sensor_fixtures.py's 16 frames at scale 4), with
    scannet.yaml and the scale-4 camera of that test."""
    tmp = tmp_path_factory.mktemp("scannet_session")
    fix = str(tmp / "seq")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "make_sensor_fixtures.py"),
         "--format", "scannet", "--out", fix, "--frames", str(FRAMES),
         "--scale", str(SCALE), "--motion-speed", str(SPEED)],
        check=True, capture_output=True, text=True)
    over = {k: dict(v) if isinstance(v, dict) else v
            for k, v in SESSION.items()}
    over["cam"] = {"H": 120, "W": 160, "fx": 577.6 / 4, "fy": 578.7 / 4,
                   "cx": (319.5 + 0.5) / 4 - 0.5,
                   "cy": (239.5 + 0.5) / 4 - 0.5, "crop_edge": 2}
    over["data"] = {"input_folder": fix, "output": str(tmp / "out")}
    overlay = str(tmp / "scannet.yaml")
    with open(overlay, "w") as f:
        f.write("inherit_from: " + json.dumps(os.path.join(
            REPO, "configs", "ScanNet", "scannet.yaml")) + "\n")
        for k, v in over.items():
            f.write(f"{k}: {json.dumps(v)}\n")
    with cpu_settings():
        stats = trun.main([overlay, "--device", "cpu"])
    return overlay, stats, str(tmp / "out")


def test_tiny_scannet_session(scannet_session):
    overlay, stats, out = scannet_session
    cfg = tload(overlay)
    assert cfg["model"]["encode_exposure"] and cfg["use_dynamic_radius"]
    assert stats["rmse"] < ATE_GATE_M, stats
    assert stats["n"] == FRAMES - 1  # one ground-truth pose is inf
    ckpt = os.path.join(out, "ckpts", f"{FRAMES - 1:05d}.pkl")
    r = load_checkpoint(ckpt)["resume"]
    ef = np.asarray(r["exposure_feat"])
    assert np.isfinite(ef).all() and np.abs(ef).max() > 0
    mapped = sorted(r["mapped_exposure"])
    assert mapped == list(range(0, FRAMES, cfg["mapping"]["every_frame"]))
    snaps = sorted(os.listdir(os.path.join(out, "ckpts", "color_decoder")))
    assert snaps == [f"{i:05d}.pkl" for i in mapped]


@pytest.mark.slow
def test_tiny_scannet_session_against_jax(scannet_session, tmp_path):
    """The JAX session on the same fixture and overlay (compile-bound)."""
    from loopy_slam_tpu.slam import LoopySLAM as JSLAM
    from loopy_slam_tpu.tools.eval_ate import evaluate_trajectories

    overlay, stats, _ = scannet_session
    cfg = jload(overlay)
    cfg["data"]["output"] = str(tmp_path / "jax")
    slam = JSLAM(cfg, output=cfg["data"]["output"])
    res = slam.run()
    jstats = evaluate_trajectories(res["estimate_c2w"], res["gt_c2w"])
    assert jstats["rmse"] < ATE_GATE_M
    assert abs(stats["rmse"] - jstats["rmse"]) < 0.03
