"""The port's submaps, loop closure and color refinement end to end on
the CPU, and chip_smoke.py's segmented configuration.

The segmented session is tests/test_multisegment_e2e.py's configuration
(120x160, a 2.5 cm segment trigger) cut from 17 frames to 9, with color
refinement on: segments open at frames 0, 2, 4, 6 and 8, so the first
correction round (3 closed segments, at frame 6) reaches the pose-graph
solve, and the last frame merges the segments and refines their colors.
One such session serves the segment, merge and refine tests. The 17-frame
session through both packages is compared by outcome in a test marked
slow, as the JAX package's own session test is.
"""

import copy
import os
import sys

import numpy as np
import pytest

from conftest import small_cfg
from loopy_slam_torch.slam import LoopySLAM
from loopy_slam_torch.tools.eval_ate import evaluate_trajectories
from loopy_slam_tpu.config import load_config, update_recursive
from torch_cpu import cpu_settings, torch_cpu  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def multisegment_cfg(out):
    cfg = small_cfg()
    cfg["verbose"] = False
    cfg["data"].update({"output": str(out), "n_frames": 17})
    cfg["cam"].update({"H": 120, "W": 160, "fx": 120.0, "fy": 120.0,
                       "cx": 79.5, "cy": 59.5})
    cfg["tracking"].update({"pixels": 300, "iters": 10, "filter": False,
                            "kval": 3, "min_dist": 1, "global_iter": 3000,
                            "dbow_filter": False})
    cfg["mapping"].update({
        "color_refine": False, "iters": 16, "iters_first": 40,
        "geo_iter_first": 15, "every_frame": 2, "keyframe_every": 2,
        "segment_rel_trans": 0.025, "segment_rot_cos": 0.9999})
    cfg["meshing"]["registration_voxel"] = 0.03
    return cfg


def _run(cfg):
    slam = LoopySLAM(cfg, device="cpu")
    try:
        res = slam.run()
    finally:
        slam.close()
    return slam, res


@pytest.fixture(scope="module")
def segmented(tmp_path_factory):
    """(slam, result, active) of the 9-frame segmented session with color
    refinement; `active` is the device map's point count just before the
    global merge."""
    cfg = multisegment_cfg(tmp_path_factory.mktemp("segments") / "out")
    cfg["data"]["n_frames"] = 9
    cfg["mapping"]["color_refine"] = True
    with cpu_settings():
        slam = LoopySLAM(cfg, device="cpu")
        active = []
        merge = slam._build_end_state

        def counted_merge():
            active.append(int(slam.map_state.count))
            merge()

        slam._build_end_state = counted_merge
        try:
            res = slam.run()
        finally:
            slam.close()
    assert len(active) == 1, active
    return slam, res, active[0]


def test_multisegment_session(segmented):
    slam, res, _ = segmented
    frags = slam.fm.fragments
    assert len(frags) >= 3, len(frags)
    closed = frags[:-1]
    for f in closed:
        assert f.npc is not None and len(f.npc) > 0
        assert f.carry_mask is not None
        assert f.reg_points is not None and len(f.reg_points) > 100
        assert f.anchor_des is not None and f.anchor_des.shape[1] == 32
    assert len(slam.lc.dbow_scores) == len(closed)
    assert all(0 <= s <= 1 for s in slam.lc.dbow_scores)
    assert len(slam.seg_timings["tsdf_fuse"]) == len(closed)
    assert slam.lc.rounds, "compute_correction never ran"
    assert any(r["solved"] for r in slam.lc.rounds)
    stats = evaluate_trajectories(res["estimate_c2w"], res["gt_c2w"])
    assert stats["rmse"] < 0.02, stats
    assert np.isfinite(res["estimate_c2w"]).all()


def test_color_refine_session(segmented):
    slam, _, active = segmented
    assert len(slam.timings["color_refine"]) == 1
    # after refinement the device map is the global merge of every
    # segment (duplicates averaged), and its index dropped no point
    merged = int(slam.map_state.count)
    total_raw = sum(len(f.npc) for f in slam.fm.fragments[:-1]) + active
    assert 100 < merged <= total_raw
    assert int(slam.map_state.grid.n_dropped) == 0


def test_fixed_segment_strategy(tmp_path, torch_cpu):
    """'fixed' opens a segment at every mapped frame whose index is a
    multiple of fixed_segment_size (tests/test_segment_strategies.py's
    case, shortened)."""
    cfg = small_cfg()
    cfg["verbose"] = False
    cfg["data"].update({"output": str(tmp_path / "out"), "n_frames": 5})
    cfg["mapping"].update({"segment_strategy": "fixed",
                           "fixed_segment_size": 4, "iters": 10,
                           "iters_first": 20, "geo_iter_first": 8,
                           "color_refine": False, "every_frame": 2})
    cfg["meshing"]["registration_voxel"] = 0.05
    slam, res = _run(cfg)
    assert [f.start_idx for f in slam.fm.fragments] == [0, 4]
    assert slam.fm.fragments[0].reg_points is not None
    assert np.isfinite(res["estimate_c2w"]).all()


@pytest.mark.slow
def test_multisegment_session_matches_jax_by_outcome(tmp_path, torch_cpu):
    from loopy_slam_tpu.slam import LoopySLAM as JaxSLAM
    from loopy_slam_tpu.tools.eval_ate import evaluate_trajectories as jeval

    cfg = multisegment_cfg(tmp_path / "jax")
    jslam = JaxSLAM(cfg)
    jres = jslam.run()
    tslam, tres = _run(multisegment_cfg(tmp_path / "torch"))
    j_ate = jeval(jres["estimate_c2w"], jres["gt_c2w"])["rmse"]
    t_ate = evaluate_trajectories(tres["estimate_c2w"],
                                  tres["gt_c2w"])["rmse"]
    assert j_ate < 0.02 and t_ate < 0.02
    assert abs(j_ate - t_ate) <= 0.01
    assert len(tslam.fm.fragments) == len(jslam.fm.fragments)


def test_chip_smoke_segmented_config_equals_room_yaml():
    sys.path.insert(0, ROOT)
    import chip_smoke

    got = chip_smoke.room_config(chip_smoke.SEGMENTED_FRAMES, "somewhere",
                                 chip_smoke.SEGMENTED_OVERRIDES)
    want = load_config(os.path.join(ROOT, "configs", "Synthetic",
                                    "room.yaml"))
    update_recursive(want, copy.deepcopy(chip_smoke.SEGMENTED_OVERRIDES))
    want["data"].update({"n_frames": chip_smoke.SEGMENTED_FRAMES,
                         "output": "somewhere"})
    assert got == want
    m = got["mapping"]
    assert m["segment_strategy"] == "rot_trans" and m["color_refine"]
    assert m["segment_rel_trans"] == 0.05
    assert m["vis_freq"] == 0 and got["tracking"]["vis_freq"] == 0
    assert got["tracking"]["kval"] == 3 and not got["tracking"]["dbow_filter"]
