"""Write the procedural Synthetic scene to disk as a TUM RGB-D, ScanNet or
Replica sequence, without cv2 (the card's machine has none).

TUM (--format tum):
  rgb/<t>.png     8-bit RGB, distorted with freiburg1's published
                  coefficients, so the loader's undistortion must recover
                  the pinhole render;
  depth/<t>.png   16-bit at 5000 per meter, pinhole (the loader does not
                  undistort depth), with elliptical zero-depth holes;
  rgb.txt, depth.txt, groundtruth.txt
                  30 Hz timestamps with jitter, ~5% of depth frames
                  dropped, poses at 100 Hz as tx ty tz qx qy qz qw of the
                  Y/Z-flipped c2w.

ScanNet (--format scannet):
  frames/color/<i>.jpg  1296x968 JPEG (quality 90) with a per-frame
                        exposure gain and channel tint, which the
                        encode_exposure path must absorb;
  frames/depth/<i>.png  640x480 16-bit at 1000 per meter, with holes;
  frames/pose/<i>.txt   the Y/Z-flipped 4x4 c2w, inf for a few frames
                        drawn from the seed (real scans have such poses).

Replica (--format replica):
  results/frame%06d.jpg  680x1200 JPEG (quality 92);
  results/depth%06d.png  16-bit at 6553.5 per meter;
  traj.txt               the Y/Z-flipped c2w of each frame, one line each.

These are the port's counterparts of scripts/make_sensor_fixtures.py (TUM,
ScanNet) and scripts/make_replica_fixture.py and draw the same numbers
from the same seeds, so the text files are the same and the images come
from the same renders. The JPEGs go through the port's writer, which
writes the bytes libjpeg-turbo writes; the distortion inverts the model by
OpenCV's iterative undistortPoints scheme and samples the clean image
bilinearly with edges replicated, as OpenCV 5's remap does; the holes are
filled ellipses as a numpy mask (cv2.ellipse draws a polygon, so a hole's
edge can differ by a pixel).

    python -m loopy_slam_torch.tools.make_sensor_fixtures --format tum \\
        --out data/TUM_RGBD/rgbd_dataset_freiburg1_desk --frames 120
    python -m loopy_slam_torch.tools.make_sensor_fixtures --format scannet \\
        --out data/ScanNet/scans/scene0000_00 --frames 400
    python -m loopy_slam_torch.tools.make_sensor_fixtures --format replica \\
        --out data/Replica/room0 --frames 2000
"""

from __future__ import annotations

import argparse
import copy
import os

import numpy as np

from ..config import DEFAULTS, update_recursive
from ..utils.datasets import Synthetic, _flip_yz
from ..utils.imageio import write_jpeg, write_png

TUM_CAM = {"H": 480, "W": 640, "fx": 517.3, "fy": 516.5,
           "cx": 318.6, "cy": 255.3, "png_depth_scale": 5000.0,
           "crop_edge": 0}
TUM_DIST = np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633])

SCANNET_DEPTH_CAM = {"H": 480, "W": 640, "fx": 577.6, "fy": 578.7,
                     "cx": 319.5, "cy": 239.5, "png_depth_scale": 1000.0,
                     "crop_edge": 0}
SCANNET_COLOR_HW = (968, 1296)

REPLICA_CAM = {"H": 680, "W": 1200, "fx": 600.0, "fy": 600.0,
               "cx": 599.5, "cy": 339.5, "png_depth_scale": 6553.5,
               "crop_edge": 0}


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


def make_dataset(cam, n_frames, motion_speed, scene=None):
    cfg = copy.deepcopy(DEFAULTS)
    data = {"n_frames": n_frames, "motion_speed": motion_speed}
    if scene is not None:
        data["scene"] = scene
    update_recursive(cfg, {"dataset": "synthetic", "cam": dict(cam),
                           "data": data})
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


def write_scannet(out, frames, motion_speed, seed=11, scale=1):
    """Returns {"frames", "bad_poses" (sorted frame indices with inf
    poses), "cam" (the depth camera)}."""
    dcam = scale_cam(SCANNET_DEPTH_CAM, scale)
    depth_ds = make_dataset(dcam, frames, motion_speed)
    ch, cw = SCANNET_COLOR_HW[0] // scale, SCANNET_COLOR_HW[1] // scale
    sx, sy = cw / dcam["W"], ch / dcam["H"]
    color_cam = dict(dcam, H=ch, W=cw, fx=dcam["fx"] * sx,
                     fy=dcam["fy"] * sy, cx=dcam["cx"] * sx,
                     cy=dcam["cy"] * sy)
    color_ds = make_dataset(color_cam, frames, motion_speed)
    rng = np.random.default_rng(seed)
    base = os.path.join(out, "frames")
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    bad_poses = set(int(i) for i in
                    rng.choice(frames, size=max(frames // 200, 1),
                               replace=False) if i > 1)
    for i in range(frames):
        c2w = depth_ds.poses[i]
        color, _ = color_ds.render_frame(c2w)
        _, depth = depth_ds.render_frame(c2w)
        # per-frame exposure: a smooth gain sweep and a slight channel tint
        gain = 1.0 + 0.25 * np.sin(2 * np.pi * i / 120.0)
        tint = 1.0 + 0.06 * np.sin(2 * np.pi * i / 90.0
                                   + np.array([0.0, 2.1, 4.2]))
        exposed = np.clip(color * gain * tint, 0.0, 1.0)
        write_jpeg(os.path.join(base, "color", f"{i}.jpg"),
                   (exposed * 255.0).round().astype(np.uint8), 90)
        depth_h = punch_holes(depth, rng, n_holes=3, frac=0.005)
        d16 = np.clip(depth_h * dcam["png_depth_scale"],
                      0, 65535).astype(np.uint16)
        write_png(os.path.join(base, "depth", f"{i}.png"), d16)
        m = np.full((4, 4), np.inf) if i in bad_poses else _flip_yz(c2w)
        np.savetxt(os.path.join(base, "pose", f"{i}.txt"), m)
    return {"frames": frames, "bad_poses": sorted(bad_poses), "cam": dcam}


def write_replica(out, frames, motion_speed, quality=92, scene="v2"):
    """Returns {"frames", "cam"}."""
    ds = make_dataset(REPLICA_CAM, frames, motion_speed, scene)
    res = os.path.join(out, "results")
    os.makedirs(res, exist_ok=True)
    scale = REPLICA_CAM["png_depth_scale"]
    for i in range(frames):
        color, depth = ds.render_frame(ds.poses[i])
        write_jpeg(os.path.join(res, f"frame{i:06d}.jpg"),
                   (color * 255.0).round().astype(np.uint8), quality)
        write_png(os.path.join(res, f"depth{i:06d}.png"),
                  np.clip(depth * scale, 0, 65535).astype(np.uint16))
    # the loader flips Y and Z on read (an involution)
    with open(os.path.join(out, "traj.txt"), "w") as f:
        for c2w in ds.poses:
            f.write(" ".join(f"{v:.9g}" for v in _flip_yz(c2w).reshape(-1))
                    + "\n")
    return {"frames": frames, "cam": dict(REPLICA_CAM)}


# per format: the orbit step a frame when --motion-speed is not given (the
# JAX package's scripts' defaults: a revisit every ~200 frames for TUM and
# ScanNet, two orbits over Replica's 2000 frames)
DEFAULT_SPEED = {"tum": 1.0 / 200.0, "scannet": 1.0 / 200.0,
                 "replica": 1.0 / 1000.0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--format", choices=("tum", "scannet", "replica"),
                    default="tum")
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--motion-speed", type=float, default=None,
                    help="orbit step a frame (default: " + ", ".join(
                        f"{k} {v:g}" for k, v in DEFAULT_SPEED.items())
                    + ")")
    ap.add_argument("--scale", type=int, default=1,
                    help="integer camera downscale (small test sequences; "
                         "TUM and ScanNet)")
    ap.add_argument("--jpeg-quality", type=int, default=92,
                    help="Replica's JPEG quality")
    ap.add_argument("--scene", default="v2", choices=("v2", "v3"),
                    help="Replica's procedural scene version")
    args = ap.parse_args(argv)
    speed = args.motion_speed or DEFAULT_SPEED[args.format]
    if args.format == "tum":
        info = write_tum(args.out, args.frames, speed, scale=args.scale)
        print(f"wrote TUM fixture: {info['rgb']} rgb / {info['depth']} "
              f"depth frames to {args.out}")
    elif args.format == "scannet":
        info = write_scannet(args.out, args.frames, speed, scale=args.scale)
        print(f"wrote ScanNet fixture: {args.frames} frames to {args.out} "
              f"({len(info['bad_poses'])} invalid poses)")
    else:
        write_replica(args.out, args.frames, speed, args.jpeg_quality,
                      args.scene)
        print(f"wrote Replica fixture: {args.frames} frames to {args.out}")


if __name__ == "__main__":
    main()
