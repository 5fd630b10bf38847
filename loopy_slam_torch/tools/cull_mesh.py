"""Frustum mesh culling: drop faces unseen by any training view (a copy of
loopy_slam_tpu/tools/cull_mesh.py, numpy).

CLI: python -m loopy_slam_torch.tools.cull_mesh --input_mesh PLY
     --output_mesh PLY --traj POSES.npy --H .. --W .. --fx .. --fy ..
     --cx .. --cy .. [--save_unseen]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.io import read_ply_mesh, write_ply_mesh


def cull_mesh(verts: np.ndarray, faces: np.ndarray, poses, cam,
              colors=None, return_unseen: bool = False):
    """Keep faces with at least one vertex inside some view frustum.

    With return_unseen=True also returns the unseen vertices: the point
    cloud of eval_recon's 2-D metric view rejection."""
    H, W = cam["H"], cam["W"]
    fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
    seen = np.zeros(len(verts), bool)
    for c2w in poses:
        w2c = np.linalg.inv(c2w)
        cp = verts @ w2c[:3, :3].T + w2c[:3, 3]
        z = -cp[:, 2]
        ok = z > 0
        u = fx * cp[:, 0] / np.maximum(z, 1e-6) + cx
        v = -fy * cp[:, 1] / np.maximum(z, 1e-6) + cy
        seen |= ok & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    face_ok = seen[faces].any(axis=1)
    keep_faces = faces[face_ok]
    used = np.unique(keep_faces)
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    out_faces = remap[keep_faces]
    out_colors = colors[used] if colors is not None else None
    if return_unseen:
        return verts[used], out_faces, out_colors, verts[~seen]
    return verts[used], out_faces, out_colors


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input_mesh", required=True)
    ap.add_argument("--output_mesh", required=True)
    ap.add_argument("--traj", required=True, help="npy (N,4,4) poses")
    ap.add_argument("--H", type=int, required=True)
    ap.add_argument("--W", type=int, required=True)
    ap.add_argument("--fx", type=float, required=True)
    ap.add_argument("--fy", type=float, required=True)
    ap.add_argument("--cx", type=float, required=True)
    ap.add_argument("--cy", type=float, required=True)
    ap.add_argument("--save_unseen", action="store_true",
                    help="also write <output_mesh>_pc_unseen.npy for "
                         "eval_recon -2d view rejection")
    args = ap.parse_args(argv)
    verts, faces, colors = read_ply_mesh(args.input_mesh)
    poses = np.load(args.traj)
    cam = {"H": args.H, "W": args.W, "fx": args.fx, "fy": args.fy,
           "cx": args.cx, "cy": args.cy}
    v, f, c, unseen = cull_mesh(verts, faces, poses, cam, colors,
                                return_unseen=True)
    write_ply_mesh(args.output_mesh, v, f, c)
    if args.save_unseen:
        unseen_path = args.output_mesh.replace(".ply", "_pc_unseen.npy")
        np.save(unseen_path, unseen.astype(np.float32))
        print(f"unseen pc: {len(unseen)} points -> {unseen_path}")
    print(f"culled: {len(verts)}->{len(v)} verts, {len(faces)}->{len(f)} faces")


if __name__ == "__main__":
    main()
