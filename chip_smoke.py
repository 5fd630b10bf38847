#!/usr/bin/env python3
"""Smoke test of loopy_slam_torch on one CUDA card.

    python3 chip_smoke.py [--frames N] [--profile] [--variants]

Phases:
  1. the card's name and power limit, torch and CUDA versions;
  2. builds the hand-written kernels from csrc/ (with --variants, also
     the VARIANTS copies of knn_select.cu, all nvcc processes at once), and
     prints the build time;
  3. holds each kernel against its plain PyTorch version on the card, at
     the main path's shapes, on a map made by the port's own insertion on
     synthetic-room frames, and times it with CUDA events: `ms`, the
     kernel's own device time (bare launches after an L2 flush, median of
     20), `ms_warm` (back-to-back launches over their count), and
     `call_ms` (the wrapper's whole call, as the main path pays it, median
     of 20), beside the plain version's `plain_ms` and the bound; with
     --variants, also `variants`: the cold ms of each variant build;
  4. runs the slice-1 path: LoopySLAM on configs/Synthetic/room.yaml's
     values (segment_strategy none, color_refine off, visualizer off) for
     16 frames (cut from 31 so that the whole script stays near ten
     minutes on the card), with the kernels' launch counts reset just
     before, and gates on launches > 0, ATE (aligned) <= 3 mm and no
     health-gate rejects;
  5. runs the segmented path: room.yaml as shipped (segment_strategy
     rot_trans, color_refine on, visualizer off) with
     mapping.segment_rel_trans 0.05, tracking.kval 3 and
     tracking.dbow_filter off for 31 frames, so that segments close every
     mapped frame and loop closure reaches the pose-graph solve;
     prints a `segments:` line (segments, each correction round,
     registration/PGO/TSDF/mesh/ORB times, the merged map and its index,
     the color-refine time, medians, ATE, launches, peak memory) and gates
     on >= 4 segments, >= 1 pose-graph solve, ATE <= 3 mm, no rejects,
     launches > 0 and finite poses (a drop in the merged map raises); then
     holds the kernel against its plain version at a fourth shape, the
     color-refine pool over the merged map;
  6. runs the CLI path: `python -m loopy_slam_torch.run` (its `main`) on
     a YAML overlay of room.yaml as shipped that changes only the frame
     count (31), the output and both vis_freq (15): first with --stop 15,
     then with --resume in a fresh session, which runs frames 16-30, color
     refinement and the final evaluation; prints an `eval:` line (resume
     frame, map counts at the checkpoint and after restore, visualizer
     images and time per vis, ATE, rejects, render and reconstruction
     metrics, the evaluation's step times, launches) and gates on the
     resume at frame 16 with the checkpoint's count restored, the four
     visualizer PNGs, ATE <= 3 mm, no rejects, a mesh with faces, psnr >
     12, accuracy < 15 cm, completion ratio > 20, a finite lpips, no
     evaluation error and launches > 0; then (6b) holds the kernel against
     its plain version at the render-chunk shape (4096 rays x N_surface
     samples) over that path's final map;
  7. (only with --profile) a torch.profiler trace of a
     6-frame session: device kernel time by kernel, and the device's busy
     share of the wall time (the profiler's own host cost included). The
     profiler's post-processing of ~1.8M kernel events takes about a
     quarter of an hour on the card's host; give the call time for it.

Prints a JSON line of per-kernel numbers, then the card's name and power
limit, then {"ok": true, "device": {...}} as the last line. Exits non-zero
(and prints no result) without a CUDA device or if any phase fails.
Imports nothing of JAX; needs no PyYAML (phases 3-5 build their config
from DEFAULTS, phase 6 reads YAML with the port's own reader).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# configs/point_slam.yaml + configs/Synthetic/room.yaml, as a dict (the card's
# machine has no PyYAML); a CPU test holds it equal to the loaded YAML
ROOM = {
    "verbose": True, "wandb": False, "setup_seed": 1219,
    "dataset": "synthetic", "project_name": "loopy_slam_tpu_synthetic",
    "use_view_direction": False, "use_dynamic_radius": False,
    "data": {"n_frames": 60, "input_folder": "",
             "output": "output/Synthetic/room"},
    "tracking": {"filter": False, "ignore_edge_W": 20, "ignore_edge_H": 20,
                 "separate_LR": True, "lr": 0.002, "pixels": 1500,
                 "iters": 40},
    "mapping": {"every_frame": 5, "keyframe_every": 5,
                "mapping_window_size": 12, "pixels": 5000,
                "pixels_adding": 6000, "pixels_based_on_color_grad": 0,
                "iters_first": 800, "iters": 300, "color_refine": True},
    "rendering": {"sample_near_pcl": False},
    "cam": {"H": 340, "W": 600, "fx": 300.0, "fy": 300.0, "cx": 299.5,
            "cy": 169.5, "png_depth_scale": 6553.5, "crop_edge": 0},
    "pointcloud": {"capacity": 262144, "cell_table_size": 131072},
    "pretrained_decoders": {"middle_fine": "pretrained/geo_decoder.pkl"},
}
# the slice-1 path: one global map, no color refinement, no visualizer
SLICE_OVERRIDES = {
    "mapping": {"segment_strategy": "none", "color_refine": False,
                "vis_freq": 0},
    "tracking": {"vis_freq": 0},
}
# the segmented path: room.yaml's own submaps and color refinement, with a
# segment trigger of 5 cm so the 31 frames close a segment at every mapped
# frame (the shipped 0.30 m closes one in 31 frames, and the correction
# needs more than 3 closed segments), and place recognition as the JAX
# package's own segmented test sets it (kval 3, no ORB-baseline floor):
# with room.yaml's kval 2 the best two anchors are the query's own and its
# neighbour's, which min_dist excludes, and anchors two segments apart
# score ~0.43-0.48 against segment baselines of ~0.50, so no loop edge is
# ever proposed on this trajectory and the pose graph is never solved
SEGMENTED_OVERRIDES = {
    "mapping": {"segment_rel_trans": 0.05, "vis_freq": 0},
    "tracking": {"vis_freq": 0, "kval": 3, "dbow_filter": False},
}
# frames of the segmented path: fewer frames propose no loop edge, so the
# pose graph is never solved
SEGMENTED_FRAMES = 31

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, f32 (non-tensor)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
ATE_GATE_M = 0.003


def room_config(n_frames: int, output: str, overrides=None):
    from loopy_slam_torch.config import DEFAULTS, update_recursive

    cfg = copy.deepcopy(DEFAULTS)
    update_recursive(cfg, copy.deepcopy(ROOM))
    update_recursive(cfg, copy.deepcopy(
        SLICE_OVERRIDES if overrides is None else overrides))
    cfg["data"]["n_frames"] = int(n_frames)
    cfg["data"]["output"] = output
    return cfg


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() over `runs` calls (CUDA events around
    each call, host work inside the window included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# L2 flush before each cold launch: 128 MB > the H100's 50 MB L2, and its
# ~40 us of writes keep the device busy while the host enqueues the launch
FLUSH_BYTES = 128 << 20
# device-side stall before a timed run (~25 ms at the H100's clock), so the
# host's enqueueing runs ahead of the device and no host gap is timed
SLEEP_CYCLES = 50_000_000


def time_device(launch, runs: int = 20, warm_runs: int = 50):
    """The kernel's own device time, from events recorded on the stream
    right around each bare launch (no wrapper work inside the window).
    Returns (cold, warm) milliseconds: cold is the median over `runs`
    launches, each after a write of FLUSH_BYTES that evicts L2 as the
    optimizer iterations between two pool builds do; warm is one window
    around `warm_runs` back-to-back launches, over the count."""
    import torch

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for a, b in ev:
        flush.zero_()
        a.record()
        launch()
        b.record()
    torch.cuda.synchronize()
    cold = sorted(a.elapsed_time(b) for a, b in ev)[runs // 2]
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(warm_runs):
        launch()
    b.record()
    torch.cuda.synchronize()
    del flush
    return cold, a.elapsed_time(b) / warm_runs


# Copies of knn_select.cu with one design choice changed or one stage cut
# out (--variants), timed beside the kernel to show what its time is made
# of: name -> (source edits, whether the outputs stay bit-equal). Each edit
# must match the source exactly once, so a changed kernel fails loudly here.
_SCAN = "for (int c = lane; c < total; c += G)"
_MERGE = "for (int rank = 0; rank < K; ++rank)"
VARIANTS = {
    "group_16": ([("constexpr int kGroup = 8;",
                   "constexpr int kGroup = 16;")], True),
    "group_32": ([("constexpr int kGroup = 8;",
                   "constexpr int kGroup = 32;")], True),
    # __match_any_sync on every query instead of only after the exact test
    "match_every_query": ([("__any_sync(kFull, repeat)",
                            "__any_sync(kFull, true)")], True),
    # the merge's min over the group by __reduce_min_sync, not shuffles
    "reduce_min_merge": ([(
        "for (int o = G / 2; o > 0; o /= 2)\n"
        "        least = min(least, __shfl_xor_sync(gmask, least, o, G));",
        "for (int o = 0; o < 1; ++o)\n"
        "        least = __reduce_min_sync(gmask, least);")], True),
    # stages cut out (wrong outputs, never compared): the candidate scan;
    # the scan and the merge; everything (a launch of the same grid)
    "no_scan": ([(_SCAN, _SCAN.replace("c < total", "c < 0"))], False),
    "no_scan_no_merge": ([(_SCAN, _SCAN.replace("c < total", "c < 0")),
                          (_MERGE, _MERGE.replace("rank < K", "rank < 0"))],
                         False),
    "empty": ([("const bool live = q < Q;",
                "const bool live = q < Q;\n  if (Q > 0) return;")], False),
}


def variant_source(src: str, name: str) -> str:
    """knn_select.cu's text `src` with the edits of VARIANTS[name]."""
    for old, new in VARIANTS[name][0]:
        if src.count(old) != 1:
            raise AssertionError(f"variant {name}: {old!r} does not occur "
                                 f"once in knn_select.cu")
        src = src.replace(old, new)
    return src


def build_variants(out_dir):
    """Build every VARIANTS copy of knn_select.cu with the kernels' nvcc
    flags, in parallel; returns {name: library} with the kernel's C
    signature declared."""
    import ctypes

    from loopy_slam_torch.csrc import build

    with open(os.path.join(os.path.dirname(build.__file__),
                           "knn_select.cu")) as f:
        src = f.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        cu = os.path.join(out_dir, f"knn_select_{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, name))
        so = cu[:-3] + ".so"
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fn = build.load_library().knn_select_launch
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.knn_select_launch.argtypes = fn.argtypes
        lib.knn_select_launch.restype = fn.restype
        libs[name] = lib
    return libs


def bare_launch(grid, q, k, radius: float, lib=None):
    """A no-argument function making the bare knn_select_launch call on
    outputs allocated once here: the wrapper's checks, allocations and
    library lookup stay outside the timed window. lib: a library other
    than the kernels' (a variant build)."""
    import ctypes

    import torch

    from loopy_slam_torch.csrc.build import load_library
    from loopy_slam_torch.ops import knn

    lib = lib or load_library()
    cd = grid.cell_data
    T, M = cd.shape[0] - 1, cd.shape[1]
    Q = q.shape[0]
    D = torch.empty((Q, k), dtype=torch.float32, device=q.device)
    I = torch.empty((Q, k), dtype=torch.int32, device=q.device)
    nn = torch.empty((Q,), dtype=torch.int32, device=q.device)
    args = (cd.data_ptr(), grid.cell_fill.data_ptr(), q.data_ptr(), None,
            ctypes.c_float(radius), grid.cell_size.data_ptr(), D.data_ptr(),
            I.data_ptr(), nn.data_ptr(), Q, T, M, knn._id_bits(M), k,
            torch.cuda.current_stream().cuda_stream)
    keep = (D, I, nn)

    def launch():
        if lib.knn_select_launch(*args) != 0:
            raise RuntimeError("knn_select_launch failed")
        return keep

    return launch


def build_kernel_map(cfg, device, frames=(0, 5, 10, 15, 20, 25, 30)):
    """A map made by the port's own insertion on synthetic-room frames
    (ground-truth poses, the main path's 6000-ray insertion batches)."""
    import torch

    from loopy_slam_torch.mapping import mapper
    from loopy_slam_torch.mapping.point_cloud import MapOptions, init_map
    from loopy_slam_torch.ops.draws import TorchDraws
    from loopy_slam_torch.slam import _upload_frame
    from loopy_slam_torch.utils.datasets import Synthetic

    ds = Synthetic(cfg)
    mopts = MapOptions.from_cfg(cfg)
    popts = mapper.MapperOptions.from_cfg(cfg)
    draw = TorchDraws(7, device)
    state = init_map(mopts, device=device)
    prev = None
    views = {}
    for i in frames:
        _, c_np, d_np, pose = ds[i]
        color, depth = _upload_frame(c_np, d_np, device)
        cur = torch.as_tensor(pose, device=device)
        state, _ = mapper.add_points_from_frame(
            state, color, depth, cur, cur if prev is None else prev, draw,
            mopts, popts, cfg["mapping"]["pixels_adding"], overlap=None)
        prev = cur
        views[i] = (color, depth, cur)
    return state, views, draw, mopts


def pool_queries(views, frames, per_frame, cfg, draw):
    """Sample positions shaped like the main path's k-NN pools: per_frame
    pixels of each frame, N_surface depth-guided samples per ray."""
    import torch

    from loopy_slam_torch.ops.camera import rays_from_uv
    from loopy_slam_torch.ops.sampling import (inside_mask_from_depth,
                                               sample_pixels, surface_z_vals)

    r = cfg["rendering"]
    out = []
    for f in frames:
        color, depth, c2w = views[f]
        H, W = depth.shape
        i, j, d, _ = sample_pixels(draw, 0, H, 0, W, per_frame, depth, color)
        inside = inside_mask_from_depth(d, d > 0)
        z = surface_z_vals(d, inside, r["N_surface"], r["near_end_surface"],
                           r["far_end_surface"], r["near_end"])
        cam = cfg["cam"]
        ro, rd = rays_from_uv(i, j, c2w, cam["fx"], cam["fy"], cam["cx"],
                              cam["cy"])
        out.append((ro[:, None, :] + rd[:, None, :] * z[..., None])
                   .reshape(-1, 3))
    return torch.cat(out).contiguous()


def knn_bound(grid, queries, k):
    """Least time for the k-NN function on these inputs, the larger of two.
    Bytes over HBM bandwidth: the fill count and the filled slots of each
    row the queries touch, read once (empty slots hold the 1e9 sentinel and
    change no output), the queries and cell_size read, D/I/neighbor_num
    written. f32 operations over the f32 peak: 8 per filled candidate in
    each query's stencil (3 sub, 3 mul, 2 add)."""
    import torch

    from loopy_slam_torch.ops import knn

    h = knn.stencil_rows(grid, queries)  # repeated probes -> empty row
    fill = grid.cell_fill.long()
    rows = torch.unique(h)
    Q = queries.shape[0]
    nbytes = (int(fill[rows].sum()) * 16 + rows.numel() * 4
              + Q * 12 + 4 + Q * (k * 8 + 4))
    ops = int(fill[h].sum()) * 8
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def check_shape(name, grid, q, k, r, variant_libs=None):
    """The kernel against its plain version on one shape (bit-equal D, I
    and neighbor_num, by the wrapper and by a bare launch), its times and
    its bound; raises on any disagreement."""
    import torch

    from loopy_slam_torch.ops import knn

    M = grid.cell_data.shape[1]
    D, I, nn = knn._query_cuda(grid, q, k, r)
    Dp, Ip, nnp = knn._query_plain(grid, q, k, r)
    torch.cuda.synchronize()
    same_I = bool(torch.equal(I, Ip))
    same_nn = bool(torch.equal(nn, nnp))
    same_D = bool(torch.equal(D.view(torch.int32), Dp.view(torch.int32)))
    err = float((D - Dp).abs().max())
    same_bare, variants = True, {}
    for vname, lib in [("kernel", None), *(variant_libs or {}).items()]:
        launch = bare_launch(grid, q, k, r, lib)
        Db, Ib, nnb = launch()
        torch.cuda.synchronize()
        if lib is None or VARIANTS[vname][1]:
            same_bare &= bool(
                torch.equal(Db.view(torch.int32), D.view(torch.int32))
                and torch.equal(Ib, I) and torch.equal(nnb, nn))
        variants[vname] = time_device(launch)
    ms, ms_warm = variants.pop("kernel")
    call_ms = time_cuda(lambda: knn._query_cuda(grid, q, k, r))
    plain_ms = time_cuda(lambda: knn._query_plain(grid, q, k, r))
    bound_ms, bound_by, nbytes, ops = knn_bound(grid, q, k)
    res = {"shape": name, "Q": int(q.shape[0]), "M": int(M),
           "table": int(grid.cell_data.shape[0] - 1),
           "id_bits": knn._id_bits(M), "D_bit_equal": same_D,
           "I_equal": same_I, "nn_equal": same_nn,
           "bare_launch_equal": same_bare,
           "max_abs_err": err, "ms": ms, "ms_warm": ms_warm,
           "call_ms": call_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / ms,
           "bytes": nbytes, "ops": ops,
           "mean_neighbors": float(nn.float().mean())}
    if variants:
        res["variants"] = {n: v[0] for n, v in variants.items()}
    print(json.dumps(res), flush=True)
    if not (same_D and same_I and same_nn and same_bare):
        raise AssertionError(f"knn_select disagrees with the plain "
                             f"version at {name}")
    return res


def kernel_phase(cfg, device, variant_libs):
    """Kernel against plain version at the main path's shapes; each
    variant build in variant_libs timed beside it."""
    import torch

    from loopy_slam_torch.ops import knn

    print("== phase 3: knn_select kernel vs plain PyTorch on the card",
          flush=True)
    state, views, draw, mopts = build_kernel_map(cfg, device)
    n_pts = int(state.count)
    print(f"map: {n_pts} points from the port's insertion, "
          f"n_dropped {int(state.grid.n_dropped)}", flush=True)
    valid = torch.arange(state.pos.shape[0], device=device) < state.count
    grid_128 = knn.build_adaptive(state.pos, valid, mopts.cell_size,
                                  mopts.table_size, max_per_cell=128)
    k = cfg["pointcloud"]["nn_num"]
    r = cfg["pointcloud"]["radius_query"]
    frames = sorted(views)
    shapes = [
        ("track_pool Q=30000 M=32", state.grid,
         pool_queries(views, frames[:1], 6000, cfg, draw)),
        ("map_pool Q=199680 M=32", state.grid,
         pool_queries(views, (frames * 2)[:12], 3328, cfg, draw)),
        ("track_pool Q=30000 M=128", grid_128,
         pool_queries(views, frames[-1:], 6000, cfg, draw)),
    ]
    results = [check_shape(name, grid, q, k, r, variant_libs)
               for name, grid, q in shapes]
    del state, views, grid_128
    torch.cuda.empty_cache()
    return results


def run_session(cfg, device):
    """LoopySLAM(cfg).run() with the kernels' launch counts reset just
    before the run and read just after. Returns (slam, result, summary)
    with the summary's common numbers and ATE."""
    import numpy as np
    import torch

    from loopy_slam_torch.ops import knn
    from loopy_slam_torch.slam import LoopySLAM
    from loopy_slam_torch.tools.eval_ate import evaluate_trajectories

    out = cfg["data"]["output"]
    t0 = time.perf_counter()
    slam = LoopySLAM(cfg, output=out, device=device)
    try:
        knn.KNN_SELECT_LAUNCHES.reset()
        torch.cuda.reset_peak_memory_stats()
        t_run = time.perf_counter()
        result = slam.run()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = knn.KNN_SELECT_LAUNCHES.count
    finally:
        slam.close()
    stats = evaluate_trajectories(result["estimate_c2w"], result["gt_c2w"])
    med = {k: float(np.median(v)) for k, v in slam.timings.items() if v}
    summary = {
        "frames": cfg["data"]["n_frames"],
        "track_median_s": med.get("track"), "map_median_s": med.get("map"),
        "data_median_s": med.get("data"),
        "upload_median_s": med.get("upload"),
        "track_times_s": slam.timings["track"],
        "map_times_s": slam.timings["map"],
        "setup_s": t_run - t0, "run_s": t_end - t_run,
        "wall_s": t_end - t0, "n_points": result["n_points"],
        "health_rejects": int(slam.track_health[1].item()),
        "ate_rmse_m": stats["rmse"],
        "ate_rmse_noalign_m": stats["rmse_no_align"],
        "knn_select_launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    return slam, result, summary


def gate_session(summary, result, what):
    import numpy as np

    if not np.isfinite(result["estimate_c2w"]).all():
        raise AssertionError(f"{what}: non-finite pose estimates")
    if summary["knn_select_launches"] <= 0:
        raise AssertionError(f"{what} never launched the knn_select kernel")
    if summary["ate_rmse_m"] > ATE_GATE_M:
        raise AssertionError(f"{what}: ATE {summary['ate_rmse_m']:.5f} m > "
                             f"{ATE_GATE_M} m")
    if summary["health_rejects"]:
        raise AssertionError(f"{what}: {summary['health_rejects']} tracking "
                             "health-gate rejects")


def slice_phase(n_frames, device):
    """The slice-1 path: LoopySLAM on the synthetic room at full width,
    one global map."""
    print(f"== phase 4: slice-1 path, synthetic room, {n_frames} frames",
          flush=True)
    cfg = room_config(n_frames, os.path.join(HERE, "output", "chip_smoke"))
    _, result, summary = run_session(cfg, device)
    print("slice:", json.dumps(summary), flush=True)
    gate_session(summary, result, "the slice-1 path")
    return summary


MIN_SEGMENTS = 4


def segmented_phase(device):
    """The segmented path: room.yaml's submaps, loop closure and color
    refinement at full width. Returns (summary, slam)."""
    import numpy as np

    n_frames = SEGMENTED_FRAMES

    print(f"== phase 5: segmented path, synthetic room, {n_frames} frames",
          flush=True)
    cfg = room_config(n_frames, os.path.join(HERE, "output",
                                             "chip_smoke_segments"),
                      SEGMENTED_OVERRIDES)
    slam, result, summary = run_session(cfg, device)
    grid = slam.map_state.grid
    st = slam.seg_timings
    summary.update({
        "segments": len(slam.fm.fragments),
        "segment_starts": [f.start_idx for f in slam.fm.fragments],
        "correction_rounds": slam.lc.rounds,
        "registration_times_s": slam.lc.registration_times,
        "pgo_times_s": slam.lc.pgo_times,
        "tsdf_fuse_s": st["tsdf_fuse"], "extract_mesh_s": st["extract_mesh"],
        "orb_frame_median_s": (float(np.median(st["orb_frame"]))
                               if st["orb_frame"] else None),
        "orb_frames": len(st["orb_frame"]),
        "dbow_scores": slam.lc.dbow_scores,
        "reg_points": [None if f.reg_points is None else len(f.reg_points)
                       for f in slam.fm.fragments],
        "merged_points": int(slam.map_state.count),
        "merged_index_M": int(grid.cell_data.shape[1]),
        "merged_index_table": int(grid.cell_data.shape[0] - 1),
        "merged_n_dropped": int(grid.n_dropped),
        "color_refine_s": slam.timings.get("color_refine", [None])[-1],
        "host_cpus": os.cpu_count(),
    })
    print("segments:", json.dumps(summary), flush=True)
    gate_session(summary, result, "the segmented path")
    if summary["segments"] < MIN_SEGMENTS:
        raise AssertionError(f"{summary['segments']} segments < "
                             f"{MIN_SEGMENTS}")
    if not any(r["solved"] for r in slam.lc.rounds):
        raise AssertionError("no loop-closure round reached the pose-graph "
                             "solve")
    if summary["merged_n_dropped"]:
        raise AssertionError("the merged map's index dropped points")
    if summary["color_refine_s"] is None:
        raise AssertionError("color refinement did not run")
    return summary, slam


def refine_pool_check(slam, cfg):
    """The kernel against its plain version at the color-refine pool's
    shape: the merged global map's index, queried at the mapper's pool
    over the refine window (every segment anchor and the last frame,
    pixel_pool_factor x pixels / 10 rays each, N_surface samples a ray)."""
    import torch

    print("== phase 5b: knn_select at the color-refine pool shape",
          flush=True)
    dev = slam.device
    views = {}
    frames = list(slam.fm.fragments)
    for i, f in enumerate(frames):
        views[i] = (torch.as_tensor(f.gt_color, device=dev),
                    torch.as_tensor(f.gt_depth, device=dev),
                    torch.as_tensor(f.anchor_est, device=dev))
    last = slam.n_img - 1
    _, c_np, d_np, _ = slam.dataset[last]
    views[len(frames)] = (torch.as_tensor(c_np, device=dev),
                          torch.as_tensor(d_np, device=dev),
                          torch.as_tensor(slam.estimate_c2w[last],
                                          device=dev))
    m = cfg["mapping"]
    per_frame = m.get("pixel_pool_factor", 8) * max(m["pixels"] // 10, 1)
    q = pool_queries(views, sorted(views), per_frame, cfg, slam.draw)
    grid = slam.map_state.grid
    name = (f"refine_pool Q={q.shape[0]} M={grid.cell_data.shape[1]} "
            f"T={grid.cell_data.shape[0] - 1}")
    return check_shape(name, grid, q, cfg["pointcloud"]["nn_num"],
                       cfg["pointcloud"]["radius_query"])


CLI_FRAMES = 31
CLI_STOP = 15
CLI_VIS_FREQ = 15
# the JAX package's own gates on its final evaluation of the synthetic room
# (tests/test_final_eval.py): psnr > 12 dB, accuracy < 15 cm, completion
# ratio > 20 %
PSNR_GATE = 12.0
ACCURACY_GATE_CM = 15.0
COMPLETION_RATIO_GATE = 20.0


def cli_overlay(out: str) -> str:
    """Write the CLI path's config: room.yaml as shipped, with only the
    frame count, the output directory and the visualizer frequency
    changed. Returns its path."""
    path = os.path.join(out, "room_cli.yaml")
    room = os.path.join(HERE, "configs", "Synthetic", "room.yaml")
    with open(path, "w") as f:
        f.write(f"inherit_from: {json.dumps(room)}\n"
                f"data: {{n_frames: {CLI_FRAMES}, "
                f"output: {json.dumps(out)}}}\n"
                f"tracking: {{vis_freq: {CLI_VIS_FREQ}}}\n"
                f"mapping: {{vis_freq: {CLI_VIS_FREQ}}}\n")
    return path


def cli_phase():
    """The CLI path: `python -m loopy_slam_torch.run <overlay> --stop 15`,
    then `... --resume` in a fresh session (frames 16-30, color
    refinement, the final evaluation), with the kernel's launch count reset
    before the first call and read after the second. Returns (summary,
    overlay path)."""
    import shutil

    from loopy_slam_torch import run as cli
    from loopy_slam_torch.config import load_config
    from loopy_slam_torch.ops import knn
    from loopy_slam_torch.utils.io import load_checkpoint

    print(f"== phase 6: the CLI path, room.yaml at {CLI_FRAMES} frames, "
          f"--stop {CLI_STOP} then --resume", flush=True)
    out = os.path.join(HERE, "output", "chip_smoke_cli")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    overlay = cli_overlay(out)
    knn.KNN_SELECT_LAUNCHES.reset()
    t0 = time.perf_counter()
    first = cli.main([overlay, "--stop", str(CLI_STOP)])
    t1 = time.perf_counter()
    ckpt = load_checkpoint(cli.latest_checkpoint(out))
    second = cli.main([overlay, "--resume"])
    t2 = time.perf_counter()
    launches = knn.KNN_SELECT_LAUNCHES.count
    vis = {d: sorted(f for f in os.listdir(os.path.join(out, d))
                     if f.endswith(".png"))
           for d in ("tracking_vis", "mapping_vis")}
    vis_bytes = {f"{d}/{f}": os.path.getsize(os.path.join(out, d, f))
                 for d, names in vis.items() for f in names}
    mesh_path = os.path.join(out, "mesh", "final_mesh.ply")
    n_faces = 0
    if os.path.exists(mesh_path):
        from loopy_slam_torch.utils.io import read_ply_mesh
        n_faces = len(read_ply_mesh(mesh_path)[1])
    keys = ("psnr", "ms_ssim", "lpips", "depth_l1", "accuracy", "completion",
            "completion ratio", "precision", "recall", "fscore", "depth l1")
    vis_s = (first["timings_s"].get("vis", [])
             + second["timings_s"].get("vis", []))
    summary = {
        "frames": CLI_FRAMES, "stop": CLI_STOP,
        "checkpoint_idx": int(ckpt["idx"]),
        "checkpoint_points": int(ckpt["map"]["count"]),
        "resume": second.get("resume"),
        "stop_run_s": t1 - t0, "resume_run_s": t2 - t1,
        "vis_images": vis_bytes, "vis_s": vis_s,
        "vis_median_s": sorted(vis_s)[len(vis_s) // 2] if vis_s else None,
        "ate_rmse_m": second["rmse"],
        "ate_rmse_noalign_m": second["rmse_no_align"],
        "health_rejects": second["health_rejects"],
        "segments": second["segments"],
        "correction_rounds": second["correction_rounds"],
        "n_points": second["n_points"],
        "color_refine_s": second["timings_s"].get("color_refine"),
        **{k: second.get(k) for k in keys},
        "eval_timings_s": second.get("eval_timings_s"),
        "eval_error": second.get("eval_error"),
        "mesh_faces": n_faces,
        "knn_select_launches": launches,
    }
    print("eval:", json.dumps(summary), flush=True)
    cfg = load_config(overlay)
    want = {f"{d}/{i:05d}_{cfg[part]['iters'] - 1:04d}.png"
            for d, part in (("tracking_vis", "tracking"),
                            ("mapping_vis", "mapping"))
            for i in (CLI_STOP, 2 * CLI_STOP)}
    failures = []
    if summary["eval_error"]:
        failures.append(f"the final evaluation failed: "
                        f"{summary['eval_error']}")
    if (summary["resume"] or {}).get("start_idx") != CLI_STOP + 1:
        failures.append(f"resumed at {summary['resume']}, not frame "
                        f"{CLI_STOP + 1}")
    elif summary["resume"]["points"] != summary["checkpoint_points"]:
        failures.append("the restored map's count differs from the "
                        "checkpoint's")
    if not want <= {k for k, v in vis_bytes.items() if v > 0}:
        failures.append(f"visualizer images missing: "
                        f"{sorted(want - set(vis_bytes))}")
    if not summary["ate_rmse_m"] <= ATE_GATE_M:
        failures.append(f"ATE {summary['ate_rmse_m']} m > {ATE_GATE_M} m")
    if summary["health_rejects"]:
        failures.append(f"{summary['health_rejects']} health-gate rejects")
    if n_faces <= 0:
        failures.append("final_mesh.ply has no faces")
    import math

    def finite(v):
        return isinstance(v, float) and math.isfinite(v)

    if not (finite(summary["psnr"]) and summary["psnr"] > PSNR_GATE):
        failures.append(f"psnr {summary['psnr']} not > {PSNR_GATE}")
    if not (finite(summary["accuracy"])
            and summary["accuracy"] < ACCURACY_GATE_CM):
        failures.append(f"accuracy {summary['accuracy']} cm not < "
                        f"{ACCURACY_GATE_CM}")
    if not (finite(summary["completion ratio"])
            and summary["completion ratio"] > COMPLETION_RATIO_GATE):
        failures.append(f"completion ratio {summary['completion ratio']} "
                        f"not > {COMPLETION_RATIO_GATE}")
    if not finite(summary["lpips"]):
        failures.append(f"lpips {summary['lpips']} not finite")
    if launches <= 0:
        failures.append("the CLI path never launched the knn_select kernel")
    if failures:
        raise AssertionError("the CLI path: " + "; ".join(failures))
    return summary, overlay


def render_chunk_check(overlay, device):
    """The kernel against its plain version at the render-chunk shape: one
    chunk of render_img (4096 rays x N_surface samples, guided by the
    frame's depth) of frame 2 * CLI_STOP at its estimated pose, over the
    CLI path's final map, indexed as restore() indexes it."""
    import numpy as np
    import torch

    from loopy_slam_torch import run as cli
    from loopy_slam_torch.config import load_config
    from loopy_slam_torch.mapping.point_cloud import MapOptions
    from loopy_slam_torch.ops import knn
    from loopy_slam_torch.ops.camera import get_rays
    from loopy_slam_torch.ops.sampling import pixels_to_points, surface_z_vals
    from loopy_slam_torch.utils.datasets import Synthetic
    from loopy_slam_torch.utils.io import load_checkpoint

    print("== phase 6b: knn_select at the render-chunk shape", flush=True)
    cfg = load_config(overlay)
    ck = load_checkpoint(cli.latest_checkpoint(cfg["data"]["output"]))
    mopts = MapOptions.from_cfg(cfg)
    n = int(ck["map"]["count"])
    cap = min(int(cfg["pointcloud"].get("initial_capacity", 2 ** 15)),
              mopts.capacity)
    while cap < n + 6000:
        cap *= 2
    pos = torch.zeros((cap, 3), device=device)
    pos[:n] = torch.as_tensor(np.asarray(ck["map"]["pos"], np.float32))
    grid = knn.build_adaptive(pos, torch.arange(cap, device=device) < n,
                              mopts.cell_size, mopts.table_size,
                              mopts.max_per_cell)
    idx = 2 * CLI_STOP
    _, _, depth_np, _ = Synthetic(cfg)[idx]
    cam = cfg["cam"]
    c2w = torch.as_tensor(np.asarray(ck["estimate_c2w_list"][idx],
                                     np.float32), device=device)
    ro, rd = get_rays(cam["H"], cam["W"], cam["fx"], cam["fy"], cam["cx"],
                      cam["cy"], c2w)
    chunk = 4096
    i0 = (cam["H"] * cam["W"] // 2) // chunk * chunk  # the middle chunk
    ro = ro.reshape(-1, 3)[i0:i0 + chunk]
    rd = rd.reshape(-1, 3)[i0:i0 + chunk]
    d = torch.as_tensor(depth_np, device=device).reshape(-1)[i0:i0 + chunk]
    r = cfg["rendering"]
    z = surface_z_vals(d, d > 0, r["N_surface"], r["near_end_surface"],
                       r["far_end_surface"], r["near_end"])
    q = pixels_to_points(ro, rd, z).reshape(-1, 3).contiguous()
    name = (f"render_chunk Q={q.shape[0]} M={grid.cell_data.shape[1]} "
            f"T={grid.cell_data.shape[0] - 1}")
    return check_shape(name, grid, q, cfg["pointcloud"]["nn_num"],
                       cfg["pointcloud"]["radius_query"])


def profile_phase(device, n_frames=6, top=15):
    """Device time by kernel over a short session, and the busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from loopy_slam_torch.slam import LoopySLAM

    print(f"== phase 7: torch.profiler over a {n_frames}-frame session",
          flush=True)
    out = os.path.join(HERE, "output", "chip_smoke_profile")
    cfg = room_config(n_frames, out)
    cfg["verbose"] = False
    slam = LoopySLAM(cfg, output=out, device=device)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            slam.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        slam.close()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_launch = sum(e.count for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    rows = [{"kernel": e.key[:90], "count": e.count,
             "device_ms": e.self_device_time_total / 1e3,
             "share": e.self_device_time_total / max(busy_us, 1)}
            for e in kernels[:top]]
    res = {"frames": n_frames, "wall_s": wall,
           "device_busy_s": busy_us / 1e6,
           "device_busy_share": busy_us / 1e6 / wall,
           "kernel_launches": n_launch,
           "timings_s": {k: sum(v) for k, v in slam.timings.items()},
           "top_kernels": rows}
    print("profile:", json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16,
                    help="frames of the slice-1 path (phase 4)")
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler trace of a 6-frame session")
    ap.add_argument("--variants", action="store_true",
                    help="also build and time the VARIANTS of knn_select.cu")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    os.chdir(HERE)  # the configs' inherit_from paths are repo-relative
    from loopy_slam_torch import resolve_device
    from loopy_slam_torch.csrc import build

    device = resolve_device()
    smi = nvidia_smi_line()
    print("== phase 1:", smi, "| torch", torch.__version__, "| cuda",
          torch.version.cuda, "|", sys.version.split()[0], flush=True)

    t0 = time.perf_counter()
    variant_libs = {}
    if args.variants:  # its nvcc processes run beside the kernels' build
        variant_libs = build_variants(
            os.path.join(HERE, "output", "chip_smoke_variants"))
    build.load_library()
    print(f"== phase 2: kernels built/loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if build.BUILD_LOG:
        print(build.BUILD_LOG["log"].strip(), flush=True)

    # the kernel check's map spans frames 0..30 whatever the slice's length
    cfg = room_config(31, os.path.join(HERE, "output", "chip_smoke"))
    shape_results = kernel_phase(cfg, device, variant_libs)
    summary = slice_phase(args.frames, device)
    seg_summary, seg_slam = segmented_phase(device)
    shape_results.append(refine_pool_check(seg_slam, seg_slam.cfg))
    del seg_slam
    torch.cuda.empty_cache()
    cli_summary, overlay = cli_phase()
    shape_results.append(render_chunk_check(overlay, device))
    if args.profile:
        profile_phase(device)

    main_shape = next(r for r in shape_results
                      if r["shape"].startswith("map_pool"))
    entry = {
        "name": "knn_select", "route": "cuda",
        "source": "loopy_slam_torch/csrc/knn_select.cu",
        "replaces": "loopy_slam_tpu/ops/knn.py:231",
        # each path's count, reset just before its run and read just after
        "launches": (summary["knn_select_launches"]
                     + seg_summary["knn_select_launches"]
                     + cli_summary["knn_select_launches"]),
        "launches_by_path": {
            "slice1": summary["knn_select_launches"],
            "segmented": seg_summary["knn_select_launches"],
            "cli": cli_summary["knn_select_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in shape_results),
        "ms": main_shape["ms"],
        "call_ms": main_shape["call_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "shapes": shape_results,
    }
    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
