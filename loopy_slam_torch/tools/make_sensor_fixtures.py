"""Write the procedural Synthetic scene to disk as a TUM RGB-D sequence,
without cv2 (the card's machine has none):

  rgb/<t>.png     8-bit RGB, distorted with freiburg1's published
                  coefficients, so the loader's undistortion must recover
                  the pinhole render;
  depth/<t>.png   16-bit at 5000 per meter, pinhole (the loader does not
                  undistort depth), with elliptical zero-depth holes;
  rgb.txt, depth.txt, groundtruth.txt
                  30 Hz timestamps with jitter, ~5% of depth frames
                  dropped, poses at 100 Hz as tx ty tz qx qy qz qw of the
                  Y/Z-flipped c2w.

It is the port's counterpart of the TUM part of
scripts/make_sensor_fixtures.py and draws the same numbers from the same
seed, so the text files are the same; the distortion inverts the model by
OpenCV's iterative undistortPoints scheme and samples the clean image
bilinearly with edges replicated, as OpenCV 5's remap does; the holes are
filled ellipses as a numpy mask (cv2.ellipse draws a polygon, so a hole's
edge can differ by a pixel).

    python -m loopy_slam_torch.tools.make_sensor_fixtures \\
        --out data/TUM_RGBD/rgbd_dataset_freiburg1_desk --frames 120
"""

from __future__ import annotations

import argparse
import copy
import os

import numpy as np

from ..config import DEFAULTS, update_recursive
from ..utils.datasets import Synthetic, _flip_yz
from ..utils.imageio import write_png

TUM_CAM = {"H": 480, "W": 640, "fx": 517.3, "fy": 516.5,
           "cx": 318.6, "cy": 255.3, "png_depth_scale": 5000.0,
           "crop_edge": 0}
TUM_DIST = np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633])


def scale_cam(cam, scale: int):
    """Divide the camera geometry by an integer factor (the distortion
    coefficients act on normalized coordinates and carry over)."""
    if scale == 1:
        return dict(cam)
    out = dict(cam)
    out["H"] = cam["H"] // scale
    out["W"] = cam["W"] // scale
    for k in ("fx", "fy"):
        out[k] = cam[k] / scale
    out["cx"] = (cam["cx"] + 0.5) / scale - 0.5
    out["cy"] = (cam["cy"] + 0.5) / scale - 0.5
    return out


def make_dataset(cam, n_frames, motion_speed):
    cfg = copy.deepcopy(DEFAULTS)
    update_recursive(cfg, {
        "dataset": "synthetic",
        "cam": dict(cam),
        "data": {"n_frames": n_frames, "motion_speed": motion_speed},
    })
    return Synthetic(cfg)


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


def punch_holes(depth, rng, n_holes=6, frac=0.02):
    """Elliptical zero-depth dropouts (~frac of the pixels), like specular
    or IR failures of a real sensor."""
    H, W = depth.shape
    mask = np.zeros((H, W), bool)
    area = int(frac * H * W / max(n_holes, 1))
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(n_holes):
        cx, cy = rng.integers(0, W), rng.integers(0, H)
        a = max(2, int(np.sqrt(area) * rng.uniform(0.5, 1.5)))
        b = max(2, area // max(a, 1))
        ang = np.deg2rad(float(rng.uniform(0, 180)))
        dx, dy = xx - int(cx), yy - int(cy)
        p = dx * np.cos(ang) + dy * np.sin(ang)
        q = -dx * np.sin(ang) + dy * np.cos(ang)
        mask |= (p / a) ** 2 + (q / b) ** 2 <= 1.0
    out = depth.copy()
    out[mask] = 0.0
    return out


def write_tum(out, frames, motion_speed, seed=7, scale=1):
    from scipy.spatial.transform import Rotation

    cam = scale_cam(TUM_CAM, scale)
    ds = make_dataset(cam, frames, motion_speed)
    rng = np.random.default_rng(seed)
    K = np.array([[cam["fx"], 0, cam["cx"]],
                  [0, cam["fy"], cam["cy"]], [0, 0, 1]])
    os.makedirs(os.path.join(out, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out, "depth"), exist_ok=True)
    t0 = 1305031100.0
    rgb_rows, depth_rows, gt_rows = [], [], []
    for i in range(frames):
        t = t0 + i / 30.0 + float(rng.uniform(-0.004, 0.004))
        color, depth = ds.render_frame(ds.poses[i])
        rgb8 = (color * 255.0).round().astype(np.uint8)
        rgb_name = f"rgb/{t:.6f}.png"
        write_png(os.path.join(out, rgb_name), distort_image(rgb8, K,
                                                             TUM_DIST))
        rgb_rows.append((t, rgb_name))
        if rng.uniform() > 0.05:  # ~5% depth drops
            td = t + float(rng.uniform(0.005, 0.02))
            d16 = np.clip(punch_holes(depth, rng) * cam["png_depth_scale"],
                          0, 65535).astype(np.uint16)
            depth_name = f"depth/{td:.6f}.png"
            write_png(os.path.join(out, depth_name), d16)
            depth_rows.append((td, depth_name))

    # poses at 100 Hz around the camera timestamps (association picks the
    # nearest within 0.08 s)
    tp0 = t0 - 0.5
    n_pose = int((frames / 30.0 + 1.0) * 100)
    for j in range(n_pose):
        tp = tp0 + j / 100.0
        fi = min(max(int(round((tp - t0) * 30.0)), 0), frames - 1)
        m = _flip_yz(ds.poses[fi])  # the sensor-convention pose
        q = Rotation.from_matrix(m[:3, :3]).as_quat()  # x y z w
        gt_rows.append((tp, *m[:3, 3], *q))

    with open(os.path.join(out, "rgb.txt"), "w") as f:
        f.write("# color images\n# fixture\n# timestamp filename\n")
        f.writelines(f"{t:.6f} {n}\n" for t, n in rgb_rows)
    with open(os.path.join(out, "depth.txt"), "w") as f:
        f.write("# depth maps\n# fixture\n# timestamp filename\n")
        f.writelines(f"{t:.6f} {n}\n" for t, n in depth_rows)
    with open(os.path.join(out, "groundtruth.txt"), "w") as f:
        # the loader skips the first line, as real TUM files start with a
        # comment there too
        f.write("# ground truth trajectory\n# fixture\n"
                "# timestamp tx ty tz qx qy qz qw\n")
        f.writelines(f"{row[0]:.6f} "
                     + " ".join(f"{v:.9g}" for v in row[1:]) + "\n"
                     for row in gt_rows)
    return {"rgb": len(rgb_rows), "depth": len(depth_rows), "cam": cam}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--motion-speed", type=float, default=1.0 / 200.0,
                    help="orbit step a frame (the default revisits every "
                         "~200 frames)")
    ap.add_argument("--scale", type=int, default=1,
                    help="integer camera downscale (small test sequences)")
    args = ap.parse_args(argv)
    info = write_tum(args.out, args.frames, args.motion_speed,
                     scale=args.scale)
    print(f"wrote TUM fixture: {info['rgb']} rgb / {info['depth']} depth "
          f"frames to {args.out}")


if __name__ == "__main__":
    main()
