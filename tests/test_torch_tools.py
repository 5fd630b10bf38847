"""The port's offline tools against the JAX package's, on the CPU, on the
same run directories, and the CLI's wandb flags.

Tolerances:
  * get_mesh_video: `shade_depth` and `orbit_poses` bit-equal (the cases
    of tests/test_mesh_video.py and a depth image with holes); the frames
    of `render_mesh_frames` pixel-equal to JAX's (decoded PNG pixels, not
    bytes: the writers differ), orbit and trajectory modes, on a mesh of
    the synthetic room. The rasterizers are the same C++ source.
  * viz_html: `export_html` writes JAX's bytes for the same run directory
    (point subsampling, the before-PGO snapshot, the exported cloud),
    on run directories saved by either package.
  * viz and eval_ate --plot: pixel-equal PNGs (the same matplotlib calls
    on equal arrays); skipped where matplotlib is missing.
  * run --wandb / --no_wandb: the flag sets cfg["wandb"] as the JAX CLI
    does (run.py:32-34, 42-43) and reaches the session's WandbLogger;
    without either flag the YAML's value stands.
"""

import copy
import os
import sys
import types

import cv2
import numpy as np
import pytest

from loopy_slam_torch.tools import eval_ate as tate
from loopy_slam_torch.tools import get_mesh_video as tvid
from loopy_slam_torch.tools import viz as tviz
from loopy_slam_torch.tools import viz_html as thtml
from loopy_slam_torch.utils import io as tio
from loopy_slam_torch.utils.imageio import read_png
from loopy_slam_tpu.tools import eval_ate as jate
from loopy_slam_tpu.tools import get_mesh_video as jvid
from loopy_slam_tpu.tools import viz as jviz
from loopy_slam_tpu.tools import viz_html as jhtml
from loopy_slam_tpu.utils import io as jio

N = 12


def _trajectories():
    t = np.linspace(0, 1, N)
    est = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    est[:, 0, 3] = 1.5 * np.cos(2 * t)
    est[:, 2, 3] = 1.5 * np.sin(2 * t)
    est[:, 1, 3] = 0.1 * t
    gt = est.copy()
    gt[:, 0, 3] += 0.01 * np.sin(7 * t)
    return est, gt


def _run_dir(root, save, n_pts=500, cloud=False, pgo=True):
    """A run directory: a final checkpoint (with the map's points), a
    before/after-PGO snapshot pair and, optionally, the exported cloud."""
    est, gt = _trajectories()
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "ckpts"), exist_ok=True)
    save(os.path.join(root, "ckpts", f"{N - 1:05d}.pkl"), {
        "idx": N - 1, "estimate_c2w_list": est, "gt_c2w_list": gt,
        "map": {"pos": rng.normal(size=(n_pts, 3)).astype(np.float32)}})
    if pgo:
        snap = np.zeros_like(est)
        snap[:6] = est[:6] + 0.05
        save(os.path.join(root, "ckpts", "00005_before_pgo.pkl"),
             {"estimate_c2w_list": snap})
        save(os.path.join(root, "ckpts", "00005_after_pgo.pkl"),
             {"estimate_c2w_list": est})
    if cloud:
        pc = np.concatenate([rng.normal(size=(n_pts, 3)),
                             rng.uniform(0, 255, (n_pts, 3))], 1)
        np.save(os.path.join(root, "final_point_cloud.npy"),
                pc.astype(np.float32))
    return root


def _pixels(path):
    """A PNG's pixels in the file's channel order (cv2 reads BGR(A))."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 2:
        return img
    return img[..., [2, 1, 0, 3][:img.shape[2]]]


# ------------------------------------------------------- get_mesh_video

def test_shade_depth_and_orbit_poses_bit_equal():
    flat = np.full((32, 32), 2.0, np.float32)
    rng = np.random.default_rng(1)
    holes = rng.uniform(0.5, 4.0, (40, 60)).astype(np.float32)
    holes[rng.random((40, 60)) < 0.1] = 0.0
    for d, f in ((flat, 60.0), (holes, 300.0)):
        np.testing.assert_array_equal(tvid.shade_depth(d, f, f),
                                      jvid.shade_depth(d, f, f))
    assert tvid.shade_depth(flat, 60.0, 60.0).min() > 0.5
    c = np.array([1.0, 2.0, 3.0])
    for n in (8, 72):
        for a, b in zip(tvid.orbit_poses(c, 2.0, 0.5, n),
                        jvid.orbit_poses(c, 2.0, 0.5, n)):
            np.testing.assert_array_equal(a, b)
            to_c = (c - a[:3, 3]) / np.linalg.norm(c - a[:3, 3])
            assert np.dot(-a[:3, 2], to_c) > 0.99


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The same mesh and checkpoint under a run directory for each
    package: the synthetic room's ground-truth mesh, coarse."""
    from loopy_slam_torch.config import DEFAULTS
    from loopy_slam_torch.utils.datasets import Synthetic

    cfg = copy.deepcopy(DEFAULTS)
    verts, faces = Synthetic(cfg).gt_mesh(divisions=24)
    out = {}
    for name, save in (("port", tio.save_checkpoint),
                       ("jax", jio.save_checkpoint)):
        root = str(tmp_path_factory.mktemp(name))
        os.makedirs(os.path.join(root, "mesh"))
        tio.write_ply_mesh(os.path.join(root, "mesh", "final_mesh.ply"),
                           verts.astype(np.float32), faces.astype(np.int32))
        _run_dir(root, save)
        out[name] = root
    return out


@pytest.mark.parametrize("orbit", [True, False])
def test_mesh_frames_pixel_equal_to_jax(mesh_runs, orbit):
    from loopy_slam_tpu.native.build import get_lib

    if get_lib() is None:
        pytest.skip("the JAX package's native toolchain is unavailable")
    kw = dict(orbit=orbit, every=3, H=60, W=80, f=60.0)
    tpaths, tmp4 = tvid.render_mesh_frames(mesh_runs["port"], **kw)
    jpaths, _ = jvid.render_mesh_frames(mesh_runs["jax"], **kw)
    assert len(tpaths) == len(jpaths) == (72 if orbit else 4)
    lit = 0
    for a, b in zip(tpaths, jpaths):
        got = read_png(a)
        assert got.shape == (60, 80, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, _pixels(b))
        lit += int(got.max() > 30)
    assert lit >= len(tpaths) // 2
    assert tmp4 is None or os.path.exists(tmp4)


def test_mesh_video_says_when_there_is_no_mp4(monkeypatch, capsys, tmp_path):
    """Without an ffmpeg-capable imageio the frames stay and the MP4 is
    None, with a line saying so."""
    monkeypatch.setitem(sys.modules, "imageio", types.ModuleType("imageio"))
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    frames = [np.zeros((4, 5, 3), np.uint8)]
    assert tvid.write_mp4(str(tmp_path / "x.mp4"), frames, 15) is None
    assert "no MP4 written" in capsys.readouterr().out


# ------------------------------------------------------------ viz_html

@pytest.mark.parametrize("case", ["subsampled", "cloud", "no_pgo"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_export_html_bytes_equal_to_jax(tmp_path, case, writer):
    save = tio.save_checkpoint if writer == "port" else jio.save_checkpoint
    root = _run_dir(str(tmp_path / "run"), save, cloud=case == "cloud",
                    pgo=case != "no_pgo")
    tp = thtml.export_html(root, str(tmp_path / "port.html"), 300)
    jp = jhtml.export_html(root, str(tmp_path / "jax.html"), 300)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        got, want = a.read(), b.read()
    assert got == want
    assert b'"n_pts": 300' in got and f'"n_frames": {N}'.encode() in got
    assert (b'"before": null' in got) == (case == "no_pgo")
    # the CLI writes the same file, into the run directory by default
    assert thtml.main(["--output", root, "--max_points", "300"]) == \
        os.path.join(root, "viewer.html")
    with open(os.path.join(root, "viewer.html"), "rb") as f:
        assert f.read() == want


# ------------------------------------------------- viz, eval_ate --plot

def test_trajectory_frames_pixel_equal_to_jax(tmp_path):
    pytest.importorskip("matplotlib")
    roots = {}
    for name, save in (("port", tio.save_checkpoint),
                       ("jax", jio.save_checkpoint)):
        roots[name] = _run_dir(str(tmp_path / name), save)
    tpaths, _ = tviz.render_trajectory_frames(roots["port"], every=3)
    jpaths, _ = jviz.render_trajectory_frames(roots["jax"], every=3)
    assert len(tpaths) == len(jpaths) == len(range(2, N, 3))
    for a, b in zip(tpaths, jpaths):
        np.testing.assert_array_equal(read_png(a), _pixels(b))


def test_eval_ate_plot_pixel_equal_to_jax(tmp_path):
    pytest.importorskip("matplotlib")
    roots = {}
    for name, save in (("port", tio.save_checkpoint),
                       ("jax", jio.save_checkpoint)):
        roots[name] = _run_dir(str(tmp_path / name), save, pgo=False)
    out = tate.main(["--output", roots["port"], "--plot"])
    want = jate.evaluate_from_output(roots["jax"], plot=True)
    assert out["rmse"] == want["rmse"]
    np.testing.assert_array_equal(
        read_png(os.path.join(roots["port"], "ate.png")),
        _pixels(os.path.join(roots["jax"], "ate.png")))


# ------------------------------------------------------- the CLI flags

class _FakeWandb(types.ModuleType):
    def __init__(self):
        super().__init__("wandb")
        self.inits = []

    def init(self, **kw):
        self.inits.append(kw)
        return types.SimpleNamespace(log=lambda payload: None,
                                     finish=lambda: None)


@pytest.mark.parametrize("flag,yaml_value,want", [
    ("--wandb", False, True), ("--no_wandb", True, False),
    (None, True, True), (None, False, False)])
def test_cli_wandb_flags(monkeypatch, tmp_path, flag, yaml_value, want):
    """run.main's flag lands in cfg["wandb"] and the session's logger: a
    stand-in wandb module sees wandb.init exactly when it is set."""
    from loopy_slam_torch import run as trun
    from loopy_slam_torch import slam as tslam

    fake = _FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    seen = {}

    class Stop(Exception):
        pass

    def stop_run(self, stop=0, start_idx=0):
        seen["cfg"], seen["logger"] = self.cfg, self.wandb
        raise Stop

    monkeypatch.setattr(tslam.LoopySLAM, "run", stop_run)
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(
        "inherit_from: configs/Synthetic/room.yaml\n"
        f"wandb: {yaml_value}\n"
        f"data: {{n_frames: 2, output: {tmp_path / 'out'}}}\n"
        "cam: {H: 30, W: 40, fx: 30.0, fy: 30.0, cx: 19.5, cy: 14.5}\n")
    argv = [str(cfg_path), "--device", "cpu"] + ([flag] if flag else [])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.chdir(repo)
    with pytest.raises(Stop):
        trun.main(argv)
    assert seen["cfg"]["wandb"] is want
    assert seen["logger"].enabled is want
    assert len(fake.inits) == int(want)
