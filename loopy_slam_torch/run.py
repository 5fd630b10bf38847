"""Command line entry point of the port:

    python -m loopy_slam_torch.run configs/Synthetic/room.yaml
        [--output DIR] [--stop N] [--resume [CKPT]] [--device cuda|cpu]

Runs tracking and mapping on the CUDA card (or the given device), prints
the trajectory's ATE and, on a run that was not stopped early with
rendering.eval_img or meshing.eval_rec on, the final evaluation (render
and reconstruction metrics). `--resume` continues a run from a checkpoint:
a .pkl path, or bare for the newest one in <output>/ckpts. The YAML files
are read by the port's own reader (no PyYAML needed).
"""

import argparse
import glob
import os
import random


def latest_checkpoint(output: str) -> str:
    """The newest checkpoint under <output>/ckpts, leaving out the
    trajectory snapshots around a pose-graph correction (*_pgo.pkl)."""
    cands = [p for p in sorted(glob.glob(os.path.join(output, "ckpts",
                                                      "*.pkl")))
             if "_pgo" not in os.path.basename(p)]
    if not cands:
        raise FileNotFoundError(f"no checkpoints in {output}/ckpts")
    return cands[-1]


def main(argv=None):
    """Run the CLI. Returns the ATE statistics with the final evaluation's
    metrics merged in (or, if the evaluation failed, its error under
    "eval_error"), so callers can gate on them; besides, the session's
    points, health-gate rejects, segments, correction rounds, its phase
    times (`timings_s`, `eval_timings_s`), the color-gradient picks'
    counts (`grad_stats`) and, on a resumed run, `resume`
    (the checkpoint, the first frame run and the restored map's points)."""
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
    parser.add_argument("--resume", type=str, default=None, nargs="?",
                        const="auto",
                        help="resume a run from a checkpoint: a .pkl path, "
                             "or bare --resume for the newest checkpoint in "
                             "<output>/ckpts")
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
        start_idx, resumed = 0, None
        if args.resume:
            path = (latest_checkpoint(slam.output) if args.resume == "auto"
                    else args.resume)
            start_idx = slam.restore(path)
            resumed = {"checkpoint": path, "start_idx": start_idx,
                       "points": int(slam.map_state.count)}
        result = slam.run(stop=cfg.get("stop", 0), start_idx=start_idx)
        stats = evaluate_trajectories(result["estimate_c2w"],
                                      result["gt_c2w"])
        print("ATE RMSE (aligned, m):", stats["rmse"])
        print("ATE RMSE (no-align, m):", stats["rmse_no_align"])
        # the session's own numbers, beside the metrics
        stats.update(n_points=result["n_points"],
                     health_rejects=int(slam.track_health[1].item()),
                     segments=len(slam.fm.fragments),
                     correction_rounds=len(slam.lc.rounds),
                     timings_s=dict(slam.timings),
                     grad_stats=dict(slam.grad_stats))
        if resumed is not None:
            stats["resume"] = resumed
        if not cfg.get("stop") and (cfg["rendering"]["eval_img"]
                                    or cfg["meshing"]["eval_rec"]):
            # an evaluation error must not lose the run: finalize() already
            # wrote the final checkpoint
            try:
                eval_stats = slam.final_eval()
                print("final eval:", eval_stats)
                stats.update(eval_stats)
                stats["eval_timings_s"] = slam.eval_timings
            except Exception as e:  # noqa: BLE001 - reported, not hidden
                import traceback

                traceback.print_exc()
                print("evaluation failed; the run is kept: its final "
                      f"checkpoint is in {slam.output}/ckpts (rerun the "
                      "evaluation with loopy_slam_torch.tools.eval_ate / "
                      "get_mesh_tsdf_fusion)")
                stats["eval_error"] = f"{type(e).__name__}: {e}"
    finally:
        slam.close()
    return stats


if __name__ == "__main__":
    main()
