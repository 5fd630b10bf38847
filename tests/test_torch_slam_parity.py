"""Slice-level parity: the JAX package and the port run the same 6-frame
tiny synthetic session from the same decoders, on the CPU.

Their random streams differ (jax.random vs torch.Generator), so the runs
are compared by outcome, not bitwise: both ATEs under 2 cm, the two ATEs
within 1 cm of each other, and point counts within 10%.
"""

import copy

import jax
import numpy as np

from loopy_slam_torch.slam import LoopySLAM as TorchSLAM
from loopy_slam_tpu.config import load_config
from loopy_slam_tpu.config import update_recursive
from loopy_slam_tpu.models.decoder import init_decoders
from loopy_slam_tpu.slam import LoopySLAM as JaxSLAM
from loopy_slam_tpu.tools.eval_ate import evaluate_trajectories
from torch_cpu import torch_cpu  # noqa: F401  (fixture)


def tiny_cfg(out):
    cfg = load_config("configs/Synthetic/room.yaml")
    update_recursive(cfg, {
        "verbose": False,
        "data": {"n_frames": 6, "output": str(out)},
        "cam": {"H": 60, "W": 80, "fx": 60.0, "fy": 60.0, "cx": 39.5,
                "cy": 29.5},
        "tracking": {"pixels": 200, "iters": 12, "ignore_edge_W": 4,
                     "ignore_edge_H": 4, "vis_freq": 0},
        "mapping": {"every_frame": 2, "pixels": 400, "pixels_adding": 800,
                    "iters": 30, "iters_first": 60, "geo_iter_first": 20,
                    "mapping_window_size": 4, "keyframe_every": 2,
                    "color_refine": False, "segment_strategy": "none",
                    "vis_freq": 0},
        "pointcloud": {"capacity": 32768, "cell_table_size": 65536,
                       "radius_add": 0.08, "radius_query": 0.16,
                       "radius_min": 0.04},
    })
    return cfg


def test_slice_matches_jax_by_outcome(tmp_path, torch_cpu):
    cfg = tiny_cfg(tmp_path / "jax")
    params = jax.tree.map(np.asarray, init_decoders(
        jax.random.PRNGKey(cfg["setup_seed"]), cfg))

    jslam = JaxSLAM(cfg)
    jslam.params = jax.tree.map(jax.numpy.asarray, params)
    jslam._load_pretrained_geo()
    jres = jslam.run()

    tcfg = copy.deepcopy(cfg)
    tcfg["data"]["output"] = str(tmp_path / "torch")
    tslam = TorchSLAM(tcfg, device="cpu", init_params=params)
    try:
        tres = tslam.run()
    finally:
        tslam.close()

    j_ate = evaluate_trajectories(jres["estimate_c2w"], jres["gt_c2w"])
    t_ate = evaluate_trajectories(tres["estimate_c2w"], tres["gt_c2w"])
    assert j_ate["rmse"] < 0.02 and t_ate["rmse"] < 0.02
    assert abs(j_ate["rmse"] - t_ate["rmse"]) <= 0.01
    assert abs(tres["n_points"] - jres["n_points"]) <= 0.1 * jres["n_points"]
    np.testing.assert_allclose(tres["gt_c2w"], jres["gt_c2w"])
