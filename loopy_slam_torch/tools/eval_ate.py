"""ATE RMSE evaluation, aligned (Horn) and un-aligned (port of the
checkpoint mode of loopy_slam_tpu/tools/eval_ate.py; the TUM-file mode
waits for the evaluation slice, ROADMAP.md Queue 1 item 12).

CLI:  python -m loopy_slam_torch.tools.eval_ate --output DIR [--no_align]
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


def evaluate_from_output(output_dir: str) -> Dict[str, float]:
    """ATE of the latest checkpoint under <output_dir>/ckpts."""
    from ..utils.io import load_checkpoint

    ckpts = sorted(glob.glob(os.path.join(output_dir, "ckpts", "*.pkl")))
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints under {output_dir}/ckpts")
    ck = load_checkpoint(ckpts[-1])
    n = ck["idx"] + 1
    return evaluate_trajectories(ck["estimate_c2w_list"][:n],
                                 ck["gt_c2w_list"][:n])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--output", required=True, help="run output dir")
    ap.add_argument("--no_align", action="store_true")
    args = ap.parse_args()
    stats = evaluate_from_output(args.output)
    key = "rmse_no_align" if args.no_align else "rmse"
    print({"absolute_translational_error.rmse": stats[key], **stats})


if __name__ == "__main__":
    main()
