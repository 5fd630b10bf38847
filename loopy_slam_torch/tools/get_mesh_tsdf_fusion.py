"""Final mesh extraction: re-render the trajectory through the trained map,
TSDF-fuse the renders on the device and extract a mesh (port of
loopy_slam_tpu/tools/get_mesh_tsdf_fusion.py, over ops/tsdf.py).

Library: mesh_from_renders(renders, poses, cam), mesh_from_slam(slam)
CLI: python -m loopy_slam_torch.tools.get_mesh_tsdf_fusion <cfg>
     --output DIR [--voxel V] [--gt_mesh PLY] [--no_eval] [--device D]
     (the map comes from the newest checkpoint under DIR/ckpts)
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from ..ops import tsdf
from ..utils.io import write_ply_mesh


def mesh_from_renders(renders, poses, cam, voxel=5.0 / 512.0, trunc=0.04,
                      depth_trunc=30.0, device=None):
    """renders: list of (color HxWx3, depth HxW) numpy pairs, fused on
    `device` (the card unless the caller asks for the CPU). Returns numpy
    (verts, faces, colors)."""
    grid = tsdf.fuse_frames(renders, poses, cam["fx"], cam["fy"],
                            cam["cx"], cam["cy"], voxel=voxel, trunc=trunc,
                            depth_trunc=depth_trunc, device=device)
    return tsdf.extract_mesh(grid)


def mesh_from_slam(slam, every: Optional[int] = None, voxel=None,
                   out_path: Optional[str] = None):
    """Render every Nth frame through the session's map at its estimated
    poses and fuse the renders."""
    every = every or slam.cfg["mapping"]["every_frame"]
    voxel = voxel or slam.cfg["meshing"].get("mesh_voxel", 5.0 / 512.0)
    renders, poses = [], []
    for idx in range(0, slam.n_img, every):
        _, _, depth_np, _ = slam.dataset[idx]
        depth, color = slam.render_img(slam.estimate_c2w[idx], depth_np)
        renders.append((color.astype(np.float32), depth.astype(np.float32)))
        poses.append(slam.estimate_c2w[idx])
    cam = {"fx": slam.fx, "fy": slam.fy, "cx": slam.cx, "cy": slam.cy}
    verts, faces, colors = mesh_from_renders(renders, poses, cam,
                                             voxel=voxel, device=slam.device)
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        write_ply_mesh(out_path, verts, faces, colors)
    return verts, faces, colors


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--output", required=True)
    ap.add_argument("--gt_mesh", default=None)
    ap.add_argument("--voxel", type=float, default=None)
    ap.add_argument("--no_eval", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..config import load_config
    from ..run import latest_checkpoint
    from ..slam import LoopySLAM

    cfg = load_config(args.config)
    cfg["data"]["output"] = args.output
    slam = LoopySLAM(cfg, output=args.output, device=args.device)
    try:
        slam.restore(latest_checkpoint(args.output))
        out_path = os.path.join(args.output, "mesh", "final_mesh.ply")
        verts, faces, colors = mesh_from_slam(slam, voxel=args.voxel,
                                              out_path=out_path)
    finally:
        slam.close()
    print(f"mesh: {len(verts)} verts, {len(faces)} faces -> {out_path}")
    if args.gt_mesh and not args.no_eval:
        from ..utils.io import read_ply_mesh
        from .eval_recon import calc_3d_metric

        gt = read_ply_mesh(args.gt_mesh)
        print(calc_3d_metric((verts, faces), gt[:2]))
    return verts, faces, colors


if __name__ == "__main__":
    main()
