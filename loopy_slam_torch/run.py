"""Command line entry point of the port:

    python -m loopy_slam_torch.run configs/Synthetic/room.yaml
        [--output DIR] [--stop N] [--device cuda|cpu]

Runs tracking and mapping on the CUDA card (or the given device) and
prints the trajectory's ATE. Evaluations not ported yet are named as such.
"""

import argparse
import random


def main(argv=None):
    """Run the CLI; returns the ATE statistics dict."""
    import numpy as np
    import torch

    from loopy_slam_torch.config import load_config
    from loopy_slam_torch.slam import LoopySLAM
    from loopy_slam_torch.tools.eval_ate import evaluate_trajectories

    parser = argparse.ArgumentParser(description="loopy_slam_torch runner")
    parser.add_argument("config", type=str, help="path to scene config yaml")
    parser.add_argument("--input_folder", type=str, default=None)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--stop", type=int, default=0,
                        help="truncate the run at the first idx % N == 0")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    if args.input_folder is not None:
        cfg["data"]["input_folder"] = args.input_folder
    if args.output is not None:
        cfg["data"]["output"] = args.output
    if args.stop:
        cfg["stop"] = args.stop
        cfg["mapping"]["ckpt_freq"] = args.stop
        cfg["mapping"]["keyframe_every"] = min(
            cfg["mapping"]["keyframe_every"], args.stop)

    random.seed(cfg["setup_seed"])
    np.random.seed(cfg["setup_seed"])
    torch.manual_seed(cfg["setup_seed"])

    slam = LoopySLAM(cfg, output=cfg["data"]["output"], device=args.device)
    try:
        result = slam.run(stop=cfg.get("stop", 0))
    finally:
        slam.close()
    stats = evaluate_trajectories(result["estimate_c2w"], result["gt_c2w"])
    print("ATE RMSE (aligned, m):", stats["rmse"])
    print("ATE RMSE (no-align, m):", stats["rmse_no_align"])
    if not cfg.get("stop") and (cfg["rendering"]["eval_img"]
                                or cfg["meshing"]["eval_rec"]):
        print("final eval (render metrics, mesh reconstruction): not ported "
              "yet in loopy_slam_torch (ROADMAP.md Queue 1 item 12); "
              "skipped")
    return stats


if __name__ == "__main__":
    main()
