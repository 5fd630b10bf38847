"""The port's visual odometer (ops/odometry.py and the motion model of
tracking.visual_odometer) and its telemetry (utils/telemetry.py) against
the JAX package, on the CPU.

Tolerances:
  * rgbd_odometry on the frames of tests/test_odometry.py: T within 1e-5
    of JAX's (measured 7e-7). 90 Gauss-Newton steps in float32 whose
    normal equations sum in another order on each side; each step
    solves a well-conditioned 6x6 system, so the difference stays at the
    rounding level. The port also meets that test's own bounds on the
    recovered motion (1.5 cm, 0.02).
  * a run stopped and resumed with the odometer on against the same run
    straight through: poses within 1e-4, as tests/test_torch_render_resume.py
    holds a resumed run (the resumed session re-reads and re-uploads the
    last frame for the odometer; the rebuilt index may sum in another
    order).
  * Timers.summary: equal to JAX's on the same records; the wandb shim
    without wandb: disabled, and log/finish do nothing.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import small_cfg
from loopy_slam_torch import run as trun
from loopy_slam_torch.ops.odometry import rgbd_odometry
from loopy_slam_torch.utils import telemetry as ttel
from loopy_slam_torch.utils.io import load_checkpoint
from loopy_slam_tpu.ops.odometry import rgbd_odometry as j_odometry
from loopy_slam_tpu.utils import telemetry as jtel
from loopy_slam_tpu.utils.datasets import Synthetic
from torch_cpu import cpu_settings, torch_cpu  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOM = os.path.join(ROOT, "configs", "Synthetic", "room.yaml")


def test_rgbd_odometry_matches_jax(torch_cpu):
    cfg = small_cfg()
    cfg["cam"].update({"H": 120, "W": 160, "fx": 120.0, "fy": 120.0,
                       "cx": 79.5, "cy": 59.5})
    ds = Synthetic(cfg)
    _, c0, d0, p0 = ds[0]
    _, c1, d1, p1 = ds[2]
    intr = (120.0, 120.0, 79.5, 59.5)
    J = np.asarray(j_odometry(jnp.asarray(c0), jnp.asarray(d0),
                              jnp.asarray(c1), jnp.asarray(d1), intr))
    T = rgbd_odometry(torch.as_tensor(c0), torch.as_tensor(d0),
                      torch.as_tensor(c1), torch.as_tensor(d1), intr).numpy()
    np.testing.assert_allclose(T, J, atol=1e-5)
    T_gt = np.linalg.inv(p1) @ p0
    assert np.abs(T_gt[:3, 3]).sum() > 0.01  # the frames moved
    assert np.abs(T[:3, 3] - T_gt[:3, 3]).max() < 0.015
    assert np.abs(T[:3, :3] - T_gt[:3, :3]).max() < 0.02


TINY = """inherit_from: "{room}"
data: {{n_frames: 5, output: "{out}"}}
cam: {{H: 60, W: 80, fx: 60.0, fy: 60.0, cx: 39.5, cy: 29.5}}
verbose: False
tracking: {{pixels: 200, iters: 12, ignore_edge_W: 4, ignore_edge_H: 4,
  vis_freq: 0, visual_odometer: True, const_speed_assumption: False}}
mapping: {{every_frame: 2, pixels: 400, pixels_adding: 800, iters: 30,
  iters_first: 60, geo_iter_first: 20, mapping_window_size: 4,
  keyframe_every: 2, color_refine: False, segment_strategy: none,
  vis_freq: 0}}
meshing: {{eval_rec: False}}
rendering: {{eval_img: False}}
pointcloud: {{capacity: 32768, cell_table_size: 65536, radius_add: 0.08,
  radius_query: 0.16, radius_min: 0.04}}
"""


def test_resume_with_the_odometer_equals_the_straight_run(tmp_path):
    """Frames 3 and 4 of a resumed run start from the odometry against
    the frame before them, which the resumed session re-read from the
    dataset."""
    paths = {}
    for name in ("straight", "resumed"):
        out = tmp_path / name
        path = tmp_path / f"{name}.yaml"
        path.write_text(TINY.format(room=ROOM, out=out))
        paths[name] = (str(path), out)
    with cpu_settings():
        straight = trun.main([paths["straight"][0], "--device", "cpu"])
        stopped = trun.main([paths["resumed"][0], "--device", "cpu",
                             "--stop", "2"])
        resumed = trun.main([paths["resumed"][0], "--device", "cpu",
                             "--resume"])
    assert len(straight["timings_s"]["odometry"]) == 3  # frames 2, 3, 4
    assert len(stopped["timings_s"]["odometry"]) == 1
    assert len(resumed["timings_s"]["odometry"]) == 2
    assert resumed["resume"]["start_idx"] == 3
    ck_s = load_checkpoint(trun.latest_checkpoint(str(paths["straight"][1])))
    ck_r = load_checkpoint(trun.latest_checkpoint(str(paths["resumed"][1])))
    np.testing.assert_allclose(ck_r["estimate_c2w_list"],
                               ck_s["estimate_c2w_list"], atol=1e-4)
    assert ck_r["map"]["count"] == ck_s["map"]["count"]
    assert straight["rmse"] < 0.02


def test_timers_summary_matches_jax():
    tt = ttel.Timers()
    jt = jtel.Timers()
    for t in (tt, jt):
        for name in ("track", "map", "track", "track"):
            with t.time(name):
                pass
        # a block that raises is timed all the same
        with pytest.raises(KeyError):
            with t.time("map"):
                raise KeyError
    assert ({k: len(v) for k, v in tt.records.items()}
            == {k: len(v) for k, v in jt.records.items()}
            == {"track": 3, "map": 2})
    jt.records.update({k: list(v) for k, v in tt.records.items()})
    assert tt.summary() == jt.summary()
    assert tt.summary()["track"]["n"] == 3


def test_wandb_shim_is_a_no_op_without_wandb(monkeypatch, capsys,
                                              tmp_path):
    import builtins

    real_import = builtins.__import__

    def no_wandb(name, *args, **kwargs):
        if name == "wandb":
            raise ImportError("No module named 'wandb'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_wandb)
    off = ttel.WandbLogger({"wandb": False}, name="x")
    assert not off.enabled and off.run is None
    on = ttel.WandbLogger({"wandb": True, "wandb_folder": str(tmp_path)},
                          name="x")
    assert not on.enabled and on.run is None
    assert "wandb disabled (ImportError)" in capsys.readouterr().out
    on.log({"a": 1.0})
    on.finish()
