"""Trajectory animation frames (port of loopy_slam_tpu/tools/viz.py).

The headless counterpart of the reference's live viewer: PNG frames of the
estimated against the ground-truth trajectory (top view, x-z), over the
map's points, from a run directory of either package; an MP4 of them where
an ffmpeg-capable imageio is installed. matplotlib is imported inside the
function, so only a call needs it (the CUDA machine has none).

CLI: python -m loopy_slam_torch.tools.viz --output <run_dir> [--every 5]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def render_trajectory_frames(output_dir: str, every: int = 5,
                             max_frames: int = 200):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..utils.imageio import read_png
    from ..utils.io import load_checkpoint
    from .get_mesh_video import write_mp4

    ckpts = sorted(glob.glob(os.path.join(output_dir, "ckpts",
                                          "[0-9]*.pkl")))
    ckpts = [c for c in ckpts if "pgo" not in c]
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints in {output_dir}/ckpts")
    ck = load_checkpoint(ckpts[-1])
    n = ck["idx"] + 1
    est = ck["estimate_c2w_list"][:n, :3, 3]
    gt = ck["gt_c2w_list"][:n, :3, 3]
    cloud = ck.get("map", {}).get("pos")

    # PGO events: replay before/after trajectories for the animation
    pgo_events = {}
    for p in sorted(glob.glob(os.path.join(output_dir, "ckpts",
                                           "*_after_pgo.pkl"))):
        seg = int(os.path.basename(p).split("_")[0])
        pgo_events[seg] = load_checkpoint(p)["estimate_c2w_list"][:n, :3, 3]

    frame_dir = os.path.join(output_dir, "viz_frames")
    os.makedirs(frame_dir, exist_ok=True)
    idxs = list(range(2, n, every))[:max_frames]
    paths = []
    for fi, k in enumerate(idxs):
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(111)
        if cloud is not None and len(cloud):
            sub = cloud[:: max(len(cloud) // 20000, 1)]
            ax.scatter(sub[:, 0], sub[:, 2], s=0.2, c="#cccccc")
        ax.plot(gt[:k, 0], gt[:k, 2], "k-", lw=1, label="ground truth")
        ax.plot(est[:k, 0], est[:k, 2], "b-", lw=1, label="estimate")
        ax.scatter([est[k - 1, 0]], [est[k - 1, 2]], c="r", s=20)
        ax.set_aspect("equal")
        ax.legend(loc="upper right", fontsize=7)
        ax.set_title(f"frame {k}")
        path = os.path.join(frame_dir, f"viz_{fi:05d}.png")
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)

    mp4 = write_mp4(os.path.join(output_dir, "trajectory.mp4"),
                    [read_png(p)[..., :3] for p in paths], 10)
    return paths, mp4


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--output", required=True)
    ap.add_argument("--every", type=int, default=5)
    args = ap.parse_args(argv)
    paths, mp4 = render_trajectory_frames(args.output, args.every)
    print(f"wrote {len(paths)} frames" + (f" + {mp4}" if mp4 else ""))
    return paths, mp4


if __name__ == "__main__":
    main()
