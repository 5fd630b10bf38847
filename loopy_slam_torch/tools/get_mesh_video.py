"""Mesh fly-through frames (port of loopy_slam_tpu/tools/get_mesh_video.py).

The reference drives an Open3D window along the estimated trajectory over
the reconstructed mesh. Headless, this renders the same storyboard: the
final mesh is rasterized by the port's z-buffer rasterizer
(ops/raster.raster_mesh_depth, csrc/raster_depth.cpp), shaded by
depth-gradient normals, and each frame is written as a PNG by the port's
writer. An MP4 of the frames is written too where an ffmpeg-capable
`imageio` is installed; without one the tool says so and returns None
for it.

Usage:
  python -m loopy_slam_torch.tools.get_mesh_video --output output/run
         [--mesh path.ply] [--every 10] [--orbit]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def shade_depth(depth: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """Lambertian-ish shading from depth-image gradients (screen-space
    normals), a headlight at the camera. Returns (H, W) in [0, 1]."""
    valid = depth > 0
    d = np.where(valid, depth, np.nan)
    # screen-space derivative of the surface: dz per pixel, scaled to
    # metric by z/f (pinhole)
    gx = np.gradient(d, axis=1) * fx / np.maximum(d, 1e-6)
    gy = np.gradient(d, axis=0) * fy / np.maximum(d, 1e-6)
    n = np.dstack([-gx, -gy, np.ones_like(d)])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    shade = np.clip(n[..., 2], 0.0, 1.0)  # headlight = +z
    # distance attenuation for depth cueing
    att = 1.0 / (1.0 + 0.06 * np.nan_to_num(d, nan=0.0))
    out = np.where(valid, 0.15 + 0.85 * shade * att, 0.0)
    return np.nan_to_num(out, nan=0.0)


def orbit_poses(center: np.ndarray, radius: float, height: float,
                n: int) -> list:
    """Turntable c2w poses looking at `center` (the camera looks along -z,
    y up)."""
    poses = []
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = center + np.array([radius * np.cos(a), height,
                                 radius * np.sin(a)])
        fwd = center - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        up2 = np.cross(right, fwd)
        c2w = np.eye(4)
        c2w[:3, 0] = right
        c2w[:3, 1] = up2
        c2w[:3, 2] = -fwd  # -z is the viewing direction
        c2w[:3, 3] = eye
        poses.append(c2w)
    return poses


def write_mp4(path: str, frames, fps: int):
    """An MP4 of the frames through imageio's ffmpeg writer; None (and a
    line on stdout) where imageio or its ffmpeg plugin is missing."""
    try:
        import imageio.v2 as imageio

        with imageio.get_writer(path, fps=fps) as w:
            for f in frames:
                w.append_data(f)
    except Exception as e:  # noqa: BLE001 - the MP4 is optional
        print(f"no MP4 written ({type(e).__name__}: an ffmpeg-capable "
              "imageio is needed); the PNG frames are complete")
        return None
    return path


def render_mesh_frames(output_dir: str, mesh_path: str | None = None,
                       every: int = 10, orbit: bool = False,
                       H: int = 340, W: int = 600, f: float = 300.0):
    """Render the mesh along the estimated trajectory (every `every`th
    pose of the newest checkpoint) or around a 72-pose turntable.
    Returns (frame_paths, mp4_path_or_None)."""
    from ..ops.raster import raster_mesh_depth
    from ..utils.imageio import write_png
    from ..utils.io import load_checkpoint, read_ply_mesh

    mesh_path = mesh_path or os.path.join(output_dir, "mesh",
                                          "final_mesh.ply")
    if not os.path.exists(mesh_path):
        raise SystemExit(f"no mesh at {mesh_path}: run the SLAM session "
                         "with meshing.eval_rec or get_mesh_tsdf_fusion "
                         "first")
    verts, faces = read_ply_mesh(mesh_path)[:2]

    if orbit:
        center = verts.mean(axis=0)
        radius = 0.8 * np.abs(verts - center).max()
        cams = orbit_poses(center, radius, 0.3 * radius, 72)
    else:
        cands = sorted(
            p for p in glob.glob(os.path.join(output_dir, "ckpts", "*.pkl"))
            if "_pgo" not in os.path.basename(p))
        if not cands:
            raise SystemExit(f"no checkpoints in {output_dir}/ckpts: "
                             "pass --orbit for a trajectory-free turntable")
        traj = np.asarray(load_checkpoint(cands[-1])["estimate_c2w_list"])
        cams = [traj[i] for i in range(0, len(traj), every)]

    frame_dir = os.path.join(output_dir, "mesh_video")
    os.makedirs(frame_dir, exist_ok=True)
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    paths, frames = [], []
    for i, c2w in enumerate(cams):
        depth = raster_mesh_depth(verts, faces, c2w, H, W, f, f, cx, cy)
        img = (255 * shade_depth(depth, f, f)).astype(np.uint8)
        rgb = np.dstack([img, img, img])
        p = os.path.join(frame_dir, f"{i:05d}.png")
        write_png(p, rgb)
        paths.append(p)
        frames.append(rgb)
    mp4 = write_mp4(os.path.join(frame_dir, "mesh_video.mp4"), frames, 15)
    return paths, mp4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--output", required=True)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--every", type=int, default=10)
    ap.add_argument("--orbit", action="store_true",
                    help="turntable around the mesh instead of the "
                         "estimated trajectory")
    args = ap.parse_args(argv)
    paths, mp4 = render_mesh_frames(args.output, args.mesh, args.every,
                                    args.orbit)
    print(f"wrote {len(paths)} frames" + (f" + {mp4}" if mp4 else ""))
    return paths, mp4


if __name__ == "__main__":
    main()
