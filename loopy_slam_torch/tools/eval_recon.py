"""3-D / 2-D mesh reconstruction metrics (port of
loopy_slam_tpu/tools/eval_recon.py; numpy and scipy on the host):

  accuracy (cm):        mean nearest-neighbour distance rec->gt over 200k
                        surface samples
  completion (cm):      mean nearest-neighbour distance gt->rec
  completion ratio (%): share of gt samples within 5 cm
  precision/recall/F-score at 1 cm
  depth L1 (cm):        |rendered depth(rec) - rendered depth(gt)| over
                        virtual views

The 2-D metric uses a fixed 500x500 focal-300 virtual camera, positions
inside the GT mesh's shrunken oriented bounding box, random look-at
targets, views rejected while any point of the gt "unseen-region" cloud
(tools/cull_mesh.py --save_unseen) projects into the frustum, and depth L1
over pixels where the reconstruction renders. Depth images come from the
host z-buffer rasterizer (ops/raster.py:raster_mesh_depth); unlike the JAX
package there is no point-splat fallback: a failed build raises.

CLI: python -m loopy_slam_torch.tools.eval_recon --rec_mesh PLY
     --gt_mesh PLY [-3d] [-2d] [--no_align] [--n_imgs N]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
from scipy.spatial import cKDTree

from ..ops.raster import raster_mesh_depth, sample_mesh_surface
from ..utils.io import read_ply_mesh


def get_align_transformation(rec_pts, gt_pts, iters=20):
    """Coarse point-to-plane ICP alignment rec->gt (threshold 0.1)."""
    from ..ops.registration import estimate_normals, icp_point_to_plane

    gt_n = estimate_normals(gt_pts, 0.1, 30)
    T, _, _ = icp_point_to_plane(rec_pts, gt_pts, gt_n, 0.1, np.eye(4),
                                 max_iter=iters)
    return T


def calc_3d_metric(rec_mesh, gt_mesh, n_samples=200000, align=True,
                   fscore_dist=0.01, rng=None) -> Dict[str, float]:
    """rec_mesh/gt_mesh: (verts, faces) tuples. Distances in cm."""
    rng = rng or np.random.default_rng(0)
    rec_pts, _ = sample_mesh_surface(*rec_mesh[:2], n_samples, rng)
    gt_pts, _ = sample_mesh_surface(*gt_mesh[:2], n_samples, rng)
    if align:
        T = get_align_transformation(rec_pts[::20], gt_pts[::20])
        rec_pts = rec_pts @ T[:3, :3].T + T[:3, 3]
    # the same distances as the JAX package's, the queries on all cores
    t_gt = cKDTree(gt_pts)
    t_rec = cKDTree(rec_pts)
    d_rec2gt, _ = t_gt.query(rec_pts, k=1, workers=-1)  # accuracy
    d_gt2rec, _ = t_rec.query(gt_pts, k=1, workers=-1)  # completion
    precision = float((d_rec2gt < fscore_dist).mean())
    recall = float((d_gt2rec < fscore_dist).mean())
    f = (2 * precision * recall / (precision + recall)
         if precision + recall > 0 else 0.0)
    return {
        "accuracy": float(d_rec2gt.mean()) * 100,
        "completion": float(d_gt2rec.mean()) * 100,
        "completion ratio": float((d_gt2rec < 0.05).mean()) * 100,
        "precision": precision * 100,
        "recall": recall * 100,
        "fscore": f * 100,
    }


def get_cam_position(gt_verts: np.ndarray):
    """Interior sampling volume for virtual camera positions: the GT mesh's
    oriented bounding box (PCA of the vertices) with extents scaled
    [0.3, 0.7, 0.7] (largest axis first) and the center lifted +0.4 along
    the box's last (smallest, ~vertical) axis."""
    c = gt_verts.mean(0)
    x = gt_verts - c
    _, R = np.linalg.eigh(x.T @ x / max(len(x), 1))
    R = R[:, ::-1]                               # descending variance
    if np.linalg.det(R) < 0:
        R[:, 2] *= -1
    proj = x @ R
    lo, hi = proj.min(0), proj.max(0)
    extents = (hi - lo) * np.array([0.3, 0.7, 0.7])
    transform = np.eye(4)
    transform[:3, :3] = R
    transform[:3, 3] = c + R @ ((lo + hi) / 2) + R[:, 2] * 0.4
    return extents, transform


def viewmatrix(lookdir, up, pos):
    """Repo-convention c2w (camera looks down -z, y up) from a look
    direction."""
    z = -lookdir / max(np.linalg.norm(lookdir), 1e-12)
    x = np.cross(up, z)
    x = x / max(np.linalg.norm(x), 1e-12)
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, :3] = np.stack([x, y, z], 1)
    m[:3, 3] = pos
    return m


def check_proj(points, W, H, fx, fy, cx, cy, c2w) -> bool:
    """True if any point projects inside the view; used to reject views
    that can see unseen GT regions."""
    if points is None or len(points) == 0:
        return False
    w2c = np.linalg.inv(c2w)
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    z = -cam[:, 2]
    in_front = z > 1e-5
    zs = np.maximum(z, 1e-5)
    u = fx * cam[:, 0] / zs + cx
    v = -fy * cam[:, 1] / zs + cy
    mask = in_front & (u > 0) & (u < W) & (v > 0) & (v < H)
    return bool(mask.any())


def calc_2d_metric(rec_mesh, gt_mesh, n_views=1000, pc_unseen=None,
                   align=True, rng=None,
                   max_attempts_per_view=200) -> Dict[str, float]:
    """Depth L1 (cm) over random interior virtual views: 500x500 focal-300
    camera, positions in the shrunken OBB interior, up = [0,0,-1],
    unseen-region view rejection, errors over pixels where the
    reconstruction has depth."""
    rng = rng or np.random.default_rng(0)
    H = W = 500
    fx = fy = 300.0
    cx = cy = 500 / 2.0 - 0.5
    rec_verts, rec_faces = rec_mesh[0], rec_mesh[1]
    if align:
        rec_sub = rec_verts[:: max(len(rec_verts) // 30000, 1)]
        gt_sub = gt_mesh[0][:: max(len(gt_mesh[0]) // 30000, 1)]
        T = get_align_transformation(rec_sub, gt_sub)
        rec_verts = rec_verts @ T[:3, :3].T + T[:3, 3]
    extents, transform = get_cam_position(gt_mesh[0])
    up = np.array([0.0, 0.0, -1.0])
    errs = []
    for _ in range(n_views):
        c2w = None
        for _attempt in range(max_attempts_per_view):
            origin = transform[:3, :3] @ (
                (rng.uniform(-0.5, 0.5, 3)) * extents) + transform[:3, 3]
            target = rng.uniform(-10000, 10000, 3) - origin
            cand = viewmatrix(target, up, origin)
            if not check_proj(pc_unseen, W, H, fx, fy, cx, cy, cand):
                c2w = cand
                break
        if c2w is None:
            continue
        d_gt = raster_mesh_depth(gt_mesh[0], gt_mesh[1], c2w, H, W, fx, fy,
                                 cx, cy)
        d_rec = raster_mesh_depth(rec_verts, rec_faces, c2w, H, W, fx, fy,
                                  cx, cy)
        m = d_rec > 0
        if m.sum() > 0:
            errs.append(np.abs(d_gt[m] - d_rec[m]).mean())
    return {"depth l1": float(np.mean(errs)) * 100 if errs else float("nan")}


def main(argv=None):
    """-3d / -2d / --no_align; the 2-D path loads <gt_mesh>_pc_unseen.npy
    if present."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rec_mesh", required=True)
    ap.add_argument("--gt_mesh", required=True)
    ap.add_argument("-3d", "--metric_3d", dest="three_d",
                    action="store_true")
    ap.add_argument("-2d", "--metric_2d", dest="two_d", action="store_true")
    ap.add_argument("--no_align", action="store_true")
    ap.add_argument("--n_imgs", type=int, default=1000)
    args = ap.parse_args(argv)
    rec = read_ply_mesh(args.rec_mesh)
    gt = read_ply_mesh(args.gt_mesh)
    out = {}
    if args.three_d or not args.two_d:
        out.update(calc_3d_metric(rec, gt, align=not args.no_align))
    if args.two_d:
        unseen_path = args.gt_mesh.replace(".ply", "_pc_unseen.npy")
        pc_unseen = (np.load(unseen_path)
                     if os.path.exists(unseen_path) else None)
        if pc_unseen is None:
            print(f"warning: {unseen_path} not found: no unseen-region "
                  "view rejection (generate with tools/cull_mesh.py "
                  "--save_unseen)")
        out.update(calc_2d_metric(rec, gt, n_views=args.n_imgs,
                                  pc_unseen=pc_unseen,
                                  align=not args.no_align))
    print(out)
    return out


if __name__ == "__main__":
    main()
