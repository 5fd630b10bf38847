"""ATE RMSE evaluation, aligned (Horn) and un-aligned (port of
loopy_slam_tpu/tools/eval_ate.py: the checkpoint mode, with `--plot`'s
top-view figure <output>/ate.png, and the TUM-file mode). matplotlib is
imported only for the figure (the CUDA machine has none).

CLI:  python -m loopy_slam_torch.tools.eval_ate [CONFIG] --output DIR
          [--no_align] [--plot]
      python -m loopy_slam_torch.tools.eval_ate [CONFIG] --est_traj F
          --gt_traj F [--offset S] [--max_difference S] [--scale X]
          [--no_align]
CONFIG, a scene's YAML, is accepted and ignored, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict

import numpy as np

from ..ops.camera import horn_align


def convert_poses(c2w_list: np.ndarray, scale=1.0):
    """Mask non-finite poses; returns (poses(N,4,4), mask)."""
    poses = []
    mask = []
    for c2w in c2w_list:
        ok = np.isfinite(c2w).all()
        mask.append(ok)
        p = c2w.copy() if ok else np.eye(4, dtype=c2w.dtype)
        p[:3, 3] *= scale
        poses.append(p)
    return np.stack(poses), np.array(mask, bool)


def evaluate_trajectories(est: np.ndarray, gt: np.ndarray,
                          align: bool = True) -> Dict[str, float]:
    """ATE on (N,4,4) trajectories: rmse (aligned), rmse_no_align and
    the aligned error's mean/median/std/min/max, in trajectory units."""
    _, mask = convert_poses(gt)
    est_t = est[mask][:, :3, 3].T
    gt_t = gt[mask][:, :3, 3].T
    _, _, err_aligned = horn_align(est_t, gt_t)
    err_raw = np.linalg.norm(est_t - gt_t, axis=0)
    return {
        "rmse": float(np.sqrt(np.mean(err_aligned ** 2))),
        "mean": float(np.mean(err_aligned)),
        "median": float(np.median(err_aligned)),
        "std": float(np.std(err_aligned)),
        "min": float(np.min(err_aligned)),
        "max": float(np.max(err_aligned)),
        "rmse_no_align": float(np.sqrt(np.mean(err_raw ** 2))),
        "n": int(mask.sum()),
    }


def read_tum_trajectory(path: str) -> Dict[float, np.ndarray]:
    """Read a TUM/freiburg-format text trajectory: one pose per line,
    `timestamp tx ty tz qx qy qz qw`, '#' comments ignored (the format of
    the TUM groundtruth.txt files and most SLAM tool outputs; reference
    eval_ate.py:268-283 consumes the same). Returns {stamp: (7,) f64}."""
    out: Dict[float, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            if len(vals) < 8:
                raise ValueError(
                    f"{path}: expected 'stamp tx ty tz qx qy qz qw', "
                    f"got {len(vals)} fields: {line!r}")
            out[vals[0]] = np.asarray(vals[1:8], np.float64)
    return out


def associate(first: Dict[float, np.ndarray],
              second: Dict[float, np.ndarray],
              offset: float = 0.0, max_difference: float = 0.02):
    """Greedy closest-stamp matching between two {stamp: data} dicts —
    the TUM benchmark's association contract (reference
    eval_ate.py:12-44): every candidate pair within max_difference is
    ranked by |Δt| and consumed greedily, each stamp used at most once.
    Returns sorted [(stamp1, stamp2)].

    Candidates come from a sorted-window sweep instead of the
    reference's full N x M cross product: a real freiburg
    groundtruth.txt logs at ~100 Hz (tens of thousands of stamps), and
    the cross product would materialize 10^8+ Python tuples. Within the
    window the candidate SET (and therefore the greedy result) is
    identical."""
    a_keys = np.asarray(sorted(first), np.float64)
    b_keys = np.asarray(sorted(second), np.float64)
    shifted = b_keys + offset
    lo = np.searchsorted(shifted, a_keys - max_difference, side="left")
    hi = np.searchsorted(shifted, a_keys + max_difference, side="right")
    cands = []
    for i, a in enumerate(a_keys):
        for j in range(lo[i], hi[i]):
            d = abs(a - shifted[j])
            if d < max_difference:
                cands.append((d, float(a), float(b_keys[j])))
    cands.sort()
    used1, used2, matches = set(), set(), []
    for _, a, b in cands:
        if a not in used1 and b not in used2:
            used1.add(a)
            used2.add(b)
            matches.append((a, b))
    matches.sort()
    return matches


def _tum_to_c2w(vec7: np.ndarray) -> np.ndarray:
    """tx ty tz qx qy qz qw -> 4x4 (translation is all ATE uses, but the
    full matrix keeps the function generally useful)."""
    t = vec7[:3]
    x, y, z, w = vec7[3:7]
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0 else 2.0 / n
    R = np.array([
        [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
        [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
        [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
    ])
    c2w = np.eye(4)
    c2w[:3, :3] = R
    c2w[:3, 3] = t
    return c2w


def evaluate_tum_files(est_path: str, gt_path: str, offset: float = 0.0,
                       max_difference: float = 0.02,
                       scale: float = 1.0) -> Dict[str, float]:
    """ATE between two timestamped freiburg-format trajectory files —
    the reference tool's standalone mode (eval_ate.py:235-266), so
    external trajectories (other SLAM systems, sensor logs) can be
    scored without a checkpoint."""
    est = read_tum_trajectory(est_path)
    gt = read_tum_trajectory(gt_path)
    matches = associate(est, gt, offset, max_difference)
    if len(matches) < 2:
        raise ValueError(
            "couldn't associate the trajectories — check --offset / "
            "--max_difference")
    est_c2w = np.stack([_tum_to_c2w(np.concatenate(
        [est[a][:3] * scale, est[a][3:]])) for a, _ in matches])
    gt_c2w = np.stack([_tum_to_c2w(gt[b]) for _, b in matches])
    return evaluate_trajectories(est_c2w, gt_c2w)


def evaluate_from_output(output_dir: str, plot: bool = False
                         ) -> Dict[str, float]:
    """ATE of the latest checkpoint under <output_dir>/ckpts; with plot,
    also the estimated and ground-truth trajectories' top view (x-z) in
    <output_dir>/ate.png."""
    from ..utils.io import load_checkpoint

    ckpts = sorted(glob.glob(os.path.join(output_dir, "ckpts", "*.pkl")))
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints under {output_dir}/ckpts")
    ck = load_checkpoint(ckpts[-1])
    n = ck["idx"] + 1
    stats = evaluate_trajectories(ck["estimate_c2w_list"][:n],
                                  ck["gt_c2w_list"][:n])
    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        est = ck["estimate_c2w_list"][:n][:, :3, 3]
        gt = ck["gt_c2w_list"][:n][:, :3, 3]
        fig, ax = plt.subplots()
        ax.plot(gt[:, 0], gt[:, 2], "k-", label="ground truth")
        ax.plot(est[:, 0], est[:, 2], "b-", label="estimated")
        ax.legend()
        ax.set_title(f"ATE RMSE {stats['rmse'] * 100:.2f} cm")
        fig.savefig(os.path.join(output_dir, "ate.png"), dpi=120)
        plt.close(fig)
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config", nargs="?", default=None,
                    help="a scene config (accepted and ignored, as the JAX "
                         "package's tool does)")
    ap.add_argument("--output", default=None,
                    help="run output dir (checkpoint mode)")
    ap.add_argument("--est_traj", default=None,
                    help="freiburg-format estimated trajectory file "
                         "(standalone mode; requires --gt_traj)")
    ap.add_argument("--gt_traj", default=None,
                    help="freiburg-format ground-truth trajectory file")
    ap.add_argument("--offset", type=float, default=0.0)
    ap.add_argument("--max_difference", type=float, default=0.02)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--no_align", action="store_true")
    ap.add_argument("--plot", action="store_true",
                    help="also write <output>/ate.png (needs matplotlib)")
    args = ap.parse_args(argv)
    if args.est_traj or args.gt_traj:
        if not (args.est_traj and args.gt_traj):
            ap.error("--est_traj and --gt_traj go together")
        stats = evaluate_tum_files(args.est_traj, args.gt_traj,
                                   args.offset, args.max_difference,
                                   args.scale)
    elif args.output:
        stats = evaluate_from_output(args.output, args.plot)
    else:
        ap.error("pass --output DIR or --est_traj/--gt_traj files")
    key = "rmse_no_align" if args.no_align else "rmse"
    out = {"absolute_translational_error.rmse": stats[key], **stats}
    print(out)
    return out


if __name__ == "__main__":
    main()
