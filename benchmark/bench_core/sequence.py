"""The one generator of the benchmark's traffic: a recorded RGB-D sequence
of the procedural room (`scene.Scene`), written in a configuration's own
dataset format, from a traffic mix's parameters and the run's seed.

Frozen copies of `loopy_slam_torch/tools/make_sensor_fixtures.write_replica`
and `write_tum` (and the distortion and dropout helpers they use), so that
a later change to the program's fixture writers cannot change the traffic.
The TUM writer draws its random numbers in the program's order (stamp
jitter, the depth drop, then the holes of each kept depth frame), so with
phase 0 and the same seed both write the same bytes
(`tests/test_bench_frozen_inputs.py`). Frames are rendered and written by
a pool of spawned worker processes; the parent makes every random draw
first, so the files do not depend on the pool's size or order.

Formats:
  replica  results/frame%06d.jpg (JPEG at the mix's quality),
           results/depth%06d.png (16-bit at png_depth_scale a meter),
           traj.txt (the Y/Z-flipped c2w of each frame, one line each);
  tumrgbd  rgb/<t>.png distorted with the camera's coefficients,
           depth/<t>.png (16-bit, pinhole, with elliptical zero-depth
           holes), rgb.txt, depth.txt, groundtruth.txt (30 Hz stamps with
           jitter, a share of depth frames dropped, poses at 100 Hz).
"""

from __future__ import annotations

import multiprocessing
import os
from typing import Dict, List, Optional

import numpy as np

from .images import write_jpeg, write_png
from .scene import Scene


def flip_yz(c2w: np.ndarray) -> np.ndarray:
    c2w = c2w.copy()
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    return c2w


def undistort_points(u, v, K, dist, iters: int = 5):
    """Normalized pinhole coordinates of distorted pixels (u, v): OpenCV's
    undistortPoints fixed-point iteration with its default 5 steps."""
    k = np.zeros(12)
    d = np.asarray(dist, np.float64).reshape(-1)
    k[:d.size] = d  # k1 k2 p1 p2 k3 k4 k5 k6
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x0 = x = (u - cx) * (1.0 / fx)
    y0 = y = (v - cy) * (1.0 / fy)
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = (1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2) / (
            1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2)
        if np.any(icdist < 0):
            raise ValueError("distortion model folds over inside the image")
        dx = 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x)
        dy = k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    return x, y


def distort_image(img, K, dist):
    """The distorted image whose undistortion recovers the pinhole render:
    each distorted pixel samples the clean image at its undistorted
    location, bilinearly with edges replicated, in float32 as OpenCV 5's
    remap does for float maps: two lerps along x, one along y, rounded."""
    H, W = img.shape[:2]
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    x, y = undistort_points(u, v, K, dist)
    map_x = (x * K[0, 0] + K[0, 2]).astype(np.float32)
    map_y = (y * K[1, 1] + K[1, 2]).astype(np.float32)
    x0, y0 = np.floor(map_x), np.floor(map_y)
    ax, ay = (map_x - x0)[..., None], (map_y - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)

    def tap(yy, xx):
        return img[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)].astype(
            np.float32)

    top = tap(y0, x0) + (tap(y0, x0 + 1) - tap(y0, x0)) * ax
    bot = tap(y0 + 1, x0) + (tap(y0 + 1, x0 + 1) - tap(y0 + 1, x0)) * ax
    return np.clip(np.rint(top + (bot - top) * ay), 0, 255).astype(np.uint8)


def draw_holes(rng, H: int, W: int, n_holes: int = 6, frac: float = 0.02):
    """The parameters of punch_holes' ellipses, in its draw order."""
    area = int(frac * H * W / max(n_holes, 1))
    holes = []
    for _ in range(n_holes):
        cx, cy = rng.integers(0, W), rng.integers(0, H)
        a = max(2, int(np.sqrt(area) * rng.uniform(0.5, 1.5)))
        b = max(2, area // max(a, 1))
        ang = np.deg2rad(float(rng.uniform(0, 180)))
        holes.append((int(cx), int(cy), a, b, ang))
    return holes


def apply_holes(depth, holes):
    """Elliptical zero-depth dropouts, like specular or IR failures of a
    real sensor (the program's punch_holes with its draws made first)."""
    H, W = depth.shape
    mask = np.zeros((H, W), bool)
    yy, xx = np.mgrid[0:H, 0:W]
    for cx, cy, a, b, ang in holes:
        dx, dy = xx - cx, yy - cy
        p = dx * np.cos(ang) + dy * np.sin(ang)
        q = -dx * np.sin(ang) + dy * np.cos(ang)
        mask |= (p / a) ** 2 + (q / b) ** 2 <= 1.0
    out = depth.copy()
    out[mask] = 0.0
    return out


def _write_frame(job) -> int:
    """Render frame i and write its files (one worker task)."""
    scene, fmt, out, i, extra = job
    color, depth = scene.render_frame(scene.pose(i))
    if fmt == "replica":
        write_jpeg(os.path.join(out, "results", f"frame{i:06d}.jpg"),
                   (color * 255.0).round().astype(np.uint8),
                   extra["quality"])
        write_png(os.path.join(out, "results", f"depth{i:06d}.png"),
                  np.clip(depth * extra["depth_scale"], 0,
                          65535).astype(np.uint16))
        return i
    rgb8 = (color * 255.0).round().astype(np.uint8)
    write_png(os.path.join(out, extra["rgb_name"]),
              distort_image(rgb8, extra["K"], extra["dist"]))
    if extra["depth_name"] is not None:
        d16 = np.clip(apply_holes(depth, extra["holes"])
                      * extra["depth_scale"], 0, 65535).astype(np.uint16)
        write_png(os.path.join(out, extra["depth_name"]), d16)
    return i


def _tum_plan(scene: Scene, cam, frames: int, rng, sensor: Dict):
    """Every random draw of the TUM writer, in the program's order: per
    frame the stamp jitter, the depth drop, and for a kept depth frame its
    stamp offset and its holes."""
    jitter = float(sensor.get("stamp_jitter_s", 0.004))
    drop = float(sensor.get("depth_drop", 0.05))
    n_holes = int(sensor.get("holes", 6))
    hole_frac = float(sensor.get("hole_frac", 0.02))
    K = np.array([[cam["fx"], 0, cam["cx"]],
                  [0, cam["fy"], cam["cy"]], [0, 0, 1]])
    t0 = 1305031100.0
    plan = []
    for i in range(frames):
        t = t0 + i / 30.0 + float(rng.uniform(-jitter, jitter))
        extra = {"rgb_name": f"rgb/{t:.6f}.png", "t": t, "K": K,
                 "dist": np.asarray(cam["distortion"], np.float64),
                 "depth_scale": cam["png_depth_scale"], "depth_name": None,
                 "holes": None}
        if rng.uniform() > drop:
            td = t + float(rng.uniform(0.005, 0.02))
            extra["holes"] = draw_holes(rng, scene.H, scene.W, n_holes,
                                        hole_frac)
            extra["depth_name"] = f"depth/{td:.6f}.png"
            extra["td"] = td
        plan.append(extra)
    return plan, t0


def _write_tum_text(out, scene: Scene, frames: int, plan, t0: float):
    from scipy.spatial.transform import Rotation

    # poses at 100 Hz around the camera timestamps (association picks the
    # nearest within 0.08 s)
    tp0 = t0 - 0.5
    n_pose = int((frames / 30.0 + 1.0) * 100)
    gt_rows = []
    for j in range(n_pose):
        tp = tp0 + j / 100.0
        fi = min(max(int(round((tp - t0) * 30.0)), 0), frames - 1)
        m = flip_yz(scene.pose(fi))  # the sensor-convention pose
        q = Rotation.from_matrix(m[:3, :3]).as_quat()  # x y z w
        gt_rows.append((tp, *m[:3, 3], *q))
    with open(os.path.join(out, "rgb.txt"), "w") as f:
        f.write("# color images\n# fixture\n# timestamp filename\n")
        f.writelines(f"{e['t']:.6f} {e['rgb_name']}\n" for e in plan)
    with open(os.path.join(out, "depth.txt"), "w") as f:
        f.write("# depth maps\n# fixture\n# timestamp filename\n")
        f.writelines(f"{e['td']:.6f} {e['depth_name']}\n" for e in plan
                     if e["depth_name"] is not None)
    with open(os.path.join(out, "groundtruth.txt"), "w") as f:
        # the loader skips the first line, as real TUM files start with a
        # comment there too
        f.write("# ground truth trajectory\n# fixture\n"
                "# timestamp tx ty tz qx qy qz qw\n")
        f.writelines(f"{row[0]:.6f} "
                     + " ".join(f"{v:.9g}" for v in row[1:]) + "\n"
                     for row in gt_rows)


def write_sequence(fmt: str, out: str, cam: Dict, frames: int,
                   motion_speed: float, phase: float, seed: int,
                   scene_name: str = "v2", sensor: Optional[Dict] = None,
                   quality: int = 92, workers: int = 1) -> Dict:
    """Write `frames` frames of the room's orbit, from orbit position
    `phase` on, into `out` in dataset format `fmt` ("replica" or
    "tumrgbd"). `seed` drives the sensor's random artifacts (TUM).
    Returns {"frames", "poses" (list of 4x4 c2w, OpenGL axes)}."""
    scene = Scene(cam, motion_speed, phase, scene_name)
    sensor = sensor or {}
    if fmt == "replica":
        os.makedirs(os.path.join(out, "results"), exist_ok=True)
        extra = {"quality": int(quality),
                 "depth_scale": cam["png_depth_scale"]}
        jobs = [(scene, fmt, out, i, extra) for i in range(frames)]
    elif fmt == "tumrgbd":
        os.makedirs(os.path.join(out, "rgb"), exist_ok=True)
        os.makedirs(os.path.join(out, "depth"), exist_ok=True)
        plan, t0 = _tum_plan(scene, cam, frames,
                             np.random.default_rng(seed), sensor)
        jobs = [(scene, fmt, out, i, plan[i]) for i in range(frames)]
    else:
        raise ValueError(f"no sequence writer for dataset format {fmt!r}")
    _run_jobs(jobs, workers)
    if fmt == "replica":
        # the loader flips Y and Z on read (an involution)
        with open(os.path.join(out, "traj.txt"), "w") as f:
            for i in range(frames):
                f.write(" ".join(f"{v:.9g}"
                                 for v in flip_yz(scene.pose(i)).reshape(-1))
                        + "\n")
    else:
        _write_tum_text(out, scene, frames, plan, t0)
    return {"frames": frames, "poses": [scene.pose(i) for i in range(frames)]}


def _run_jobs(jobs: List, workers: int) -> None:
    if workers <= 1:
        for job in jobs:
            _write_frame(job)
        return
    # numpy's own threads would oversubscribe the cores the pool shares
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                             "OPENBLAS_NUM_THREADS",
                                             "MKL_NUM_THREADS")}
    os.environ.update({k: "1" for k in saved})
    try:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            done = sorted(pool.map(_write_frame, jobs, chunksize=1))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if done != [job[3] for job in jobs]:
        raise RuntimeError("the writer pool lost frames")
