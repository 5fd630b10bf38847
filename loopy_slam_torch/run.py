"""Command line entry point of the port:

    python -m loopy_slam_torch.run configs/Synthetic/room.yaml
        [--output DIR] [--stop N] [--resume [CKPT]] [--device cuda|cpu]
        [--wandb | --no_wandb] [--spans PATH]

Runs tracking and mapping on the CUDA card (or the given device), prints
the trajectory's ATE and, on a run that was not stopped early with
rendering.eval_img or meshing.eval_rec on, the final evaluation (render
and reconstruction metrics). `--resume` continues a run from a checkpoint:
a .pkl path, or bare for the newest one in <output>/ckpts. The YAML files
are read by the port's own reader (no PyYAML needed). `--wandb` and
`--no_wandb` set the config's `wandb` (the losses go to wandb when it is
set and wandb imports); without either the YAML's value stands.
`--spans PATH` turns the session's tracer to its detail level
(utils/telemetry.py) and appends each frame's spans to PATH, one JSON
object a line, at the frame's end (rank 0's, on a mesh).

With parallel.n_devices = n > 1 (ray data parallelism, or with
parallel.map_shard the cell-sharded map) the session runs on n spawned
ranks (parallel/mesh.launch, rank r on cuda:(r % cards), or all on the CPU
with --device cpu; the rendezvous and each rank's result live in a
temporary directory under <output>/.mesh, removed afterwards). Rank 0
prints, evaluates and writes the outputs; a failed rank fails the run.
"""

import argparse
import glob
import os
import random
import time


def latest_checkpoint(output: str) -> str:
    """The newest checkpoint under <output>/ckpts, leaving out the
    trajectory snapshots around a pose-graph correction (*_pgo.pkl)."""
    cands = [p for p in sorted(glob.glob(os.path.join(output, "ckpts",
                                                      "*.pkl")))
             if "_pgo" not in os.path.basename(p)]
    if not cands:
        raise FileNotFoundError(f"no checkpoints in {output}/ckpts")
    return cands[-1]


def session(mesh, cfg, device=None, resume=None, after_run=None,
            spans=None):
    """One session of the CLI on this rank (mesh None: the only one): run,
    score the trajectory and, on rank 0 of a finished run, the final
    evaluation. Returns main()'s statistics; on a mesh also `rank`: this
    rank's checksum of the replicated state (LoopySLAM.
    replicated_checksum), k-NN and tracker render kernel launches during
    the run, shard count and collective times. after_run(slam), if given,
    is called on rank 0 with the finished session before it closes; its
    result goes under "after_run". spans: the path --spans writes to, or
    None."""
    import numpy as np
    import torch

    from loopy_slam_torch.models import track_render
    from loopy_slam_torch.ops import knn
    from loopy_slam_torch.slam import LoopySLAM
    from loopy_slam_torch.tools.eval_ate import evaluate_trajectories

    random.seed(cfg["setup_seed"])
    np.random.seed(cfg["setup_seed"])
    torch.manual_seed(cfg["setup_seed"])
    slam = LoopySLAM(cfg, output=cfg["data"]["output"], device=device,
                     mesh=mesh)
    if spans and slam.rank == 0:
        slam.tracer.enable(path=spans)
    try:
        start_idx, resumed = 0, None
        if resume:
            path = (latest_checkpoint(slam.output) if resume == "auto"
                    else resume)
            start_idx = slam.restore(path)
            resumed = {"checkpoint": path, "start_idx": start_idx,
                       "points": int(slam.map_state.count)}
        knn.KNN_SELECT_LAUNCHES.reset()
        track_render.TRACK_RENDER_LAUNCHES.reset()
        if mesh is not None:
            mesh.reset_stats()
        t0 = time.perf_counter()
        result = slam.run(stop=cfg.get("stop", 0), start_idx=start_idx)
        run_s = time.perf_counter() - t0
        launches = knn.KNN_SELECT_LAUNCHES.count
        track_launches = track_render.TRACK_RENDER_LAUNCHES.count
        stats = evaluate_trajectories(result["estimate_c2w"],
                                      result["gt_c2w"])
        if slam.rank == 0:
            print("ATE RMSE (aligned, m):", stats["rmse"])
            print("ATE RMSE (no-align, m):", stats["rmse_no_align"])
        # the session's own numbers, beside the metrics
        stats.update(n_points=result["n_points"],
                     health_rejects=int(slam.track_health[1].item()),
                     segments=len(slam.fm.fragments),
                     correction_rounds=len(slam.lc.rounds),
                     timings_s=dict(slam.timings),
                     grad_stats=dict(slam.grad_stats),
                     ba_frames=list(slam.ba_frames))
        if mesh is not None:
            stats["rank"] = {
                "rank": mesh.rank, "backend": mesh.backend,
                "checksum": slam.replicated_checksum(), "run_s": run_s,
                "knn_select_launches": launches,
                "track_render_launches": track_launches,
                "shard_count": (int(slam._smap.count) if slam.map_sharded
                                else None),
                "collectives": {k: {"s": v[0], "calls": int(v[1]),
                                    "bytes": int(v[2])}
                                for k, v in mesh.stats.items()}}
        if resumed is not None:
            stats["resume"] = resumed
        if slam.rank == 0 and not cfg.get("stop") and (
                cfg["rendering"]["eval_img"] or cfg["meshing"]["eval_rec"]):
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
        if after_run is not None and slam.rank == 0:
            stats["after_run"] = after_run(slam)
    finally:
        slam.close()
    return stats


def main(argv=None, after_run=None):
    """Run the CLI. Returns the ATE statistics with the final evaluation's
    metrics merged in (or, if the evaluation failed, its error under
    "eval_error"), so callers can gate on them; besides, the session's
    points, health-gate rejects, segments, correction rounds, its phase
    times (`timings_s`, `eval_timings_s`), the color-gradient picks'
    counts (`grad_stats`), the mapped frames that ran bundle adjustment
    (`ba_frames`) and, on a resumed run, `resume`
    (the checkpoint, the first frame run and the restored map's points).
    after_run(slam) (one device only) is called with the finished
    session, e.g. for its roofline(); its result is under "after_run"."""
    from loopy_slam_torch.config import load_config
    from loopy_slam_torch.parallel.mesh import launch
    from loopy_slam_torch.slam import parallel_ranks

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
    parser.add_argument("--wandb", dest="wandb", action="store_true")
    parser.add_argument("--no_wandb", dest="wandb", action="store_false")
    parser.set_defaults(wandb=None)
    parser.add_argument("--spans", type=str, default=None,
                        help="append the run's spans to this file as JSON "
                             "lines, a frame at a time")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    if args.input_folder is not None:
        cfg["data"]["input_folder"] = args.input_folder
    if args.output is not None:
        cfg["data"]["output"] = args.output
    if args.wandb is not None:
        cfg["wandb"] = args.wandb
    if args.stop:
        cfg["stop"] = args.stop
        cfg["mapping"]["ckpt_freq"] = args.stop
        cfg["mapping"]["keyframe_every"] = min(
            cfg["mapping"]["keyframe_every"], args.stop)

    n = parallel_ranks(cfg)
    if n == 1:
        return session(None, cfg, args.device, args.resume, after_run,
                       spans=args.spans)
    if after_run is not None:
        raise ValueError("after_run runs on one device only")
    # every rank runs the session; rank 0's statistics, with each rank's
    # own summary under "ranks"
    results = launch(session, n, cfg, args.device, args.resume,
                     device=args.device, store_dir=os.path.join(cfg["data"]["output"], ".mesh"),
                     spans=args.spans)
    stats = results[0]
    stats["ranks"] = [r.pop("rank") for r in results]
    return stats


if __name__ == "__main__":
    main()
