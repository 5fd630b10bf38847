"""The benchmark's frozen inputs equal the program's today: the scene, the
sequence writers (byte for byte), the resolved configurations and the
pretrained trunk's checksum. CPU only, small sizes.

    python -m pytest benchmark/tests -q
"""

import copy
import filecmp
import hashlib
import json
import os

import numpy as np
import pytest

import tiny  # noqa: F401  (puts the repo and the benchmark on sys.path)
from bench_core.scene import Scene
from bench_core.sequence import write_sequence

from loopy_slam_torch.config import DEFAULTS, load_config, update_recursive
from loopy_slam_torch.tools import make_sensor_fixtures as fixtures
from loopy_slam_torch.utils.datasets import Synthetic


def _same_tree(a, b):
    names = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _, fs in os.walk(a) for f in fs)
    names_b = sorted(os.path.relpath(os.path.join(r, f), b)
                     for r, _, fs in os.walk(b) for f in fs)
    assert names == names_b
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n


@pytest.mark.parametrize("scene", ["v2", "v3"])
def test_scene_equals_programs(scene):
    cam = {"H": 34, "W": 60, "fx": 30.0, "fy": 30.0, "cx": 29.5, "cy": 16.5,
           "png_depth_scale": 6553.5, "crop_edge": 0}
    cfg = copy.deepcopy(DEFAULTS)
    update_recursive(cfg, {"dataset": "synthetic", "cam": cam,
                           "data": {"n_frames": 7, "motion_speed": 0.004,
                                    "scene": scene}})
    theirs = Synthetic(cfg)
    ours = Scene(cam, 0.004, 0.0, scene)
    for i in (0, 3, 6):
        np.testing.assert_array_equal(ours.pose(i), theirs.poses[i])
        for a, b in zip(ours.render_frame(ours.pose(i)),
                        theirs.render_frame(theirs.poses[i])):
            np.testing.assert_array_equal(a, b)


def test_phase_shifts_the_orbit():
    cam = {"H": 8, "W": 8, "fx": 8.0, "fy": 8.0, "cx": 3.5, "cy": 3.5}
    a, b = Scene(cam, 0.01, 0.25), Scene(cam, 0.01, 0.0)
    np.testing.assert_allclose(a.pose(0), b.pose(25), atol=1e-12)


def test_tum_writer_equals_programs(tmp_path):
    fixtures.write_tum(str(tmp_path / "theirs"), 4, 0.004, seed=7, scale=4)
    cam = dict(fixtures.scale_cam(fixtures.TUM_CAM, 4),
               distortion=list(fixtures.TUM_DIST))
    write_sequence("tumrgbd", str(tmp_path / "ours"), cam, 4, 0.004, 0.0, 7,
                   workers=2)
    _same_tree(str(tmp_path / "theirs"), str(tmp_path / "ours"))


def test_replica_writer_equals_programs(tmp_path):
    fixtures.write_replica(str(tmp_path / "theirs"), 2, 0.0008)
    write_sequence("replica", str(tmp_path / "ours"),
                   dict(fixtures.REPLICA_CAM), 2, 0.0008, 0.0, 0, workers=1)
    _same_tree(str(tmp_path / "theirs"), str(tmp_path / "ours"))


@pytest.mark.parametrize("name", ["replica-room0", "tum-fr1-desk"])
def test_frozen_config_equals_programs_resolution(name):
    with open(os.path.join(tiny.BENCH, "configs", f"{name}.json")) as f:
        frozen = json.load(f)
    cwd = os.getcwd()
    os.chdir(tiny.REPO)  # inherit_from paths are relative to the root
    try:
        today = load_config(frozen["resolved_from"])
    finally:
        os.chdir(cwd)
    today.pop("config_path", None)
    assert json.loads(json.dumps(today)) == frozen["resolved"]
    for rel, digest in frozen["assets_sha256"].items():
        with open(os.path.join(tiny.REPO, rel), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == digest
