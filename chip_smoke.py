#!/usr/bin/env python3
"""Smoke test of loopy_slam_torch on one CUDA card.

    python3 chip_smoke.py [--frames N] [--profile] [--variants]
                          [--dataset-runs N] [--base-runs N]
                          [--tools-runs N] [--multi-runs N]
                          [--debug-index]

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
     6 frames (cut from 31, then 16, then 8, then 6, so that the whole
     script with the TUM, Replica and ScanNet paths stays near 1000 s on
     the card), with the kernels' launch counts reset just
     before, and gates on launches > 0, ATE (aligned) <= 3 mm and no
     health-gate rejects; then checks that utils/cost.CostCounter sees
     autograd's backward on the card (a Linear's forward and backward
     read 3x its forward product) and prints the path's `roofline:` line
     (roofline_report: LoopySLAM.roofline()'s flops, transcendentals and
     bytes of the last tracked frame and of the last steady mapped frame
     (its n_geo and n_col, the counts of its last full geometry and color
     chunks, which scaled by their stages' iterations sum to the frame's
     count), each frame's index and own wall time beside the median
     steady times of a tracked and a mapped frame (the second on), the
     k-NN's share of the bytes, the counter's unclassified op names,
     achieved TFLOP/s and TB/s over each frame's own time and their
     shares of the card's f32 and HBM peaks, and the accounting's own
     seconds), gated on
     flops and bytes > 0, every share in (0, 1.05] (more than the peak
     means a wrong count) and the trajectory, the map's features and the
     launch count unchanged by the accounting;
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
     count (11, cut from 31), the output and both vis_freq (5): first
     with --stop 5, then with --resume in a fresh session, which runs
     frames 6-10, color refinement and the final evaluation; prints an
     `eval:` line (resume frame, map counts at the checkpoint and after
     restore, visualizer images and time per vis, the decode check of the
     visualizer's JPEG, ATE, rejects, render and reconstruction metrics,
     the evaluation's step times, launches) and gates on the
     resume at frame 6 with the checkpoint's count restored, the four
     visualizer JPEGs (<idx:05d>_<iter:04d>.jpg, the JAX package's
     names), the last frame's visualizer JPEG decoded by read_jpeg within
     VIS_JPEG_MIN_PSNR_DB of its six panels, ATE <= 3 mm, no rejects, a
     mesh with faces, psnr >
     12, accuracy < 15 cm, completion ratio > 20, a finite lpips, no
     evaluation error and launches > 0; then (6b) holds the kernel against
     its plain version at the render-chunk shape (4096 rays x N_surface
     samples) over that path's final map;
  7. (only with --profile, after phase 8) a torch.profiler trace of a
     6-frame session: device kernel time by kernel, and the device's busy
     share of the wall time (the profiler's own host cost included). The
     profiler's post-processing of ~1.8M kernel events takes about a
     quarter of an hour on the card's host; give the call time for it.
  8. runs the TUM path: the port's fixture writer
     (loopy_slam_torch.tools.make_sensor_fixtures) writes a 16-frame
     TUM-format sequence of the synthetic room in freiburg1's geometry
     (480x640, its published distortion, jittered 30 Hz timestamps,
     dropped depth frames, zero-depth holes), then
     `python -m loopy_slam_torch.run` runs
     configs/TUM_RGBD/freiburg1_desk.yaml as shipped on it (dynamic query
     radius, color-gradient picks, 5000 tracking pixels x 200 iterations,
     10000 mapping pixels, the final evaluation), only the input, the
     output, both vis_freq (6) and color refinement changed (off, for
     phase 13's time: ~55 s on the H100; ScanNet's path keeps a
     refinement with the dynamic radius, as do the segmented and CLI
     paths); prints a `tum:`
     line (frames, crop, the r_query map's median/min/max, the gradient
     pool and inserts, the phase times, ATE, rejects, peak memory,
     launches, the host's PNG decoding and undistortion seconds a frame)
     and gates on >= 10 associated frames, ATE < 2 cm, no rejects,
     gradient inserts > 0, a mesh with faces, no evaluation error and
     launches > 0, with the path's `roofline:` line and gates as in phase 4
     (through run.main's after_run); then (8b) holds the kernel against
     its plain version,
     with per-query radii, at the tracking pool and a mapping pool over
     that path's final map;
  9. runs the Replica path: the fixture writer puts a 6-frame
     Replica-format sequence of the synthetic room (680x1200 JPEG color
     at quality 92 through the port's own JPEG writer, 16-bit depth,
     traj.txt; 0.004 of the orbit a frame) on disk, and the CLI runs
     configs/Replica/room0.yaml as shipped on it (1500 tracking pixels x
     40 iterations, 5000 mapping pixels over a window of 12, 1500 first
     iterations, the final evaluation), only the input, the output, both
     vis_freq (5) and color refinement (off, for phase 12's time; four
     paths keep it) changed; prints a `replica:` line
     (ATE, rejects, launches, the phase times, color refinement, psnr,
     mesh faces, peak memory, the host's read_jpeg and depth-PNG ms a
     frame) and gates on ATE < 1 cm, no rejects, launches > 0, psnr > 12,
     a mesh with faces and no evaluation error; then (9b) holds the
     kernel against its plain version at Replica's mapping pool;
 10. runs the ScanNet path: a 6-frame ScanNet-format sequence (1296x968
     JPEG color at quality 90 with a per-frame exposure gain and tint,
     640x480 depth with holes, one inf ground-truth pose) and
     configs/ScanNet/scene0000.yaml as shipped (exposure compensation, the
     dynamic radius, 5000 gradient-pool tracking pixels x 100
     iterations, 10000 mapping pixels over a window of 20, crop_edge 10);
     prints a `scannet:` line (ATE, masked ground-truth poses, rejects,
     launches, the exposure latent's norm, the color-decoder snapshots,
     the phase times, psnr, the host's read_jpeg and resize_linear ms a
     frame) and gates on ATE < 2 cm, an inf pose masked, no rejects,
     launches > 0, a finite non-zero latent, one snapshot and one latent
     per mapped frame, psnr > 12 and no evaluation error; then (10b)
     holds the kernel against its plain version, with per-query radii,
     at ScanNet's tracking pool;

 11. runs the base-config path: the CLI on an overlay of
     configs/TUM_RGBD/freiburg1_desk.yaml over phase 8's sequence with the
     options the reference's base config has and no shipped dataset YAML
     turns on: rendering.sample_near_pcl (zero-depth rays sample between
     the first two of 25 probe depths where the map lies; no k-NN cache
     or ray pool, so every iteration runs its own k-NN and its probe),
     mapping.BA (the window's poses trained once it holds more than 4
     keyframes) and tracking.visual_odometer (RGB-D odometry from the
     previous frame as the motion model, const_speed_assumption off);
     widths as shipped, depth cut (BASE_OVERRIDES: keyframe_every 2,
     submaps, color refinement, evaluation and visualizer off, 100 tracking
     and 500 / 100 mapping iterations); then renders the last frame through
     the restored map; prints a `base:` line (ATE, rejects, launches, BA's
     mapped frames and the keyframe poses it moved, odometer calls and ms
     a call, the zero-depth share, the rendered frame's hole pixels and
     those with a probe depth, the phase times, peak memory) and gates on
     ATE < 2 cm, no rejects, launches > 0, BA on >= 2 mapped frames with
     a keyframe moved > 1e-7 m, an odometer pose on every tracked frame
     from frame 2 with every pose finite, >= 0.5 % zero-depth pixels and a
     rendered hole pixel with a finite depth > 0; then (11b) holds the
     kernel against its plain version at the probe's two shapes (the
     tracking probes, pixels x 25, and a render chunk's, 4096 x 25) at the
     scalar radius_query;
 12. runs the last inputs and the offline tools: (12a) `python -m
     loopy_slam_torch.tools.pretrain_geo` (its main) at its shipped 4
     scenes x 400 iterations, writing output/chip_smoke_tools/geo.pkl
     (never pretrained/geo_decoder.pkl), with the kernel's count reset
     just before; prints a `pretrain:` line (each scene's losses and
     seconds, ms an iteration, launches, the held-out losses) and gates on
     finite losses, the shipped trunk's keys, shapes and dtypes, finite
     entries moved from their initial values, a held-out room's
     frozen-trunk geometry loss below 0.8 of the initial trunk's, and
     launches > 0; (12a') holds the kernel at its mapping pool; (12b) the
     fixture writer's 6-frame Azure sequence (720x1280 JPEG, 16-bit depth,
     scene/trajectory.log) through the CLI on configs/point_slam.yaml with
     dataset azure, crop_size 384x512 and 12a's trunk (AZURE_OVERRIDES);
     prints an `azure:` line (ATE, rejects, launches, the frames' shapes,
     the loader's host ms a frame) and gates on ATE < 2 cm, no rejects,
     launches > 0 and frames of crop_size; (12b') holds the kernel at its
     tracking rays with per-query radii; (12c) writes 4 CoFusion frames
     (PNG color, ZIP EXR depth) and loads them through get_dataset: the
     depth must equal the written depth over png_depth_scale, bit for bit
     (its `cofusion:` line has read_exr's ms a frame); (12d) runs
     get_mesh_video (the 72-pose turntable, then every 5th pose) and viz_html
     on phase 6's run directory, gated on PNGs with non-constant pixels
     and an HTML payload that parses and holds the run's point and pose
     counts (its `tools:` line).
 13. multi-device, two ranks sharing the card (gloo by the backend rule
     of parallel/mesh.py, psum and ring hops through CUDA IPC mailboxes):
     (13a) the mailboxes held bit-equal against gloo on host copies (psum
     and ring_shift by +1 and -1 of seeded float32 and int32 payloads at
     the ring fetch's and ray-DP's widths, and one payload larger than a
     mailbox, so the exchange goes in pieces; its `mailbox:` line), the
     port's dry run (parallel/dryrun.py: one ray-DP and one
     map-shard chunk at tiny shapes inside their loss bands) and a
     one-rank NCCL process group with an all_reduce (NCCL's code path;
     two ranks on one card cannot use it); (13b) the map-shard session
     and (13c) the ray-DP session: phase 4's configuration (room.yaml's
     widths, 6 frames) with parallel.n_devices 2 (and map_shard for
     13b), each through parallel/mesh.launch and run.session, with the
     kernel's launch count reset on each rank just before its run; each
     prints a `multi:` line (ATE, rejects, points, shard counts, each
     rank's launches, checksum of the replicated state, run seconds and
     collective seconds, calls and bytes, the collective ms an optimizer
     iteration, the phase medians beside phase 4's) and gates on ATE <=
     3 mm, no rejects, launches > 0 on every rank, equal checksums and,
     for 13b, both shards non-empty and summing to the gathered map; a
     failed rank ends the script (its traceback in the error, its own
     output on this process's stdout and stderr). No depth cut
     (MULTI_OVERRIDES: phase 4's own); phase 13's time came from the TUM
     path's color refinement. (13d) holds the kernel at one shard's local mapping
     batch (the mapped frames of 13b's run as a 12-frame window, pixels /
     window / 2 rays each) and tracking batch (pixels / 2 rays) on that
     shard's local grid, rebuilt from the run's gathered checkpoint, and
     at a ray-DP rank's mapping pool on 13c's map.

Prints a JSON line of per-kernel numbers, the script's seconds, then the
card's name and power limit, then {"ok": true, "device": {...}} as the
last line. Exits non-zero (and prints no result) without a CUDA device or
if any phase fails. `--dataset-runs N` runs only phases 9 and 10, N times
each with their gates, for their run-to-run spread (no kernels line, no
result line); `--base-runs N` runs only phases 11 and 11b (writing phase
8's sequence first), N times; `--tools-runs N` runs only phase 12, N
times (phase 6 first when its run directory has no mesh);
`--multi-runs N` runs only phase 13 (N times, with 13d once);
`--debug-index` (a debugging mode, with
`--base-runs`) checks every CUDA index op's indices on the device until
the first mapped frame ends and prints the call sites out of range
(IndexProbe: it clamps them, so gates do not hold in this mode). A
failing phase's traceback goes to stdout as well as stderr.
Imports nothing of JAX; needs no PyYAML, cv2 or PIL (phases 3-5 build
their config from DEFAULTS, phases 6 and 8-10 read YAML with the port's
own reader, and phases 8-12 write and read their PNGs, JPEGs and EXRs
with the port's codecs; matplotlib is never called).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time
import traceback

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


def bare_launch(grid, q, k, radius, lib=None):
    """A no-argument function making the bare knn_select_launch call on
    outputs allocated once here: the wrapper's checks, allocations and
    library lookup stay outside the timed window. radius: a float, or a
    contiguous (Q,) float32 tensor of per-query radii (the kernel's radius
    pointer). lib: a library other than the kernels' (a variant build)."""
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
    if isinstance(radius, torch.Tensor):
        r_ptr, r_scalar = radius.data_ptr(), 0.0
    else:
        r_ptr, r_scalar = None, float(radius)
    args = (cd.data_ptr(), grid.cell_fill.data_ptr(), q.data_ptr(), r_ptr,
            ctypes.c_float(r_scalar), grid.cell_size.data_ptr(),
            D.data_ptr(), I.data_ptr(), nn.data_ptr(), Q, T, M,
            knn._id_bits(M), k, torch.cuda.current_stream().cuda_stream)
    keep = (D, I, nn, radius)

    def launch():
        if lib.knn_select_launch(*args) != 0:
            raise RuntimeError("knn_select_launch failed")
        return keep[:3]

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


def knn_bound(grid, queries, k, per_query_radius=False):
    """Least time for the k-NN function on these inputs, the larger of two:
    ops/knn.query_cost's bytes (the filled slots of the rows the queries
    touch, their fill counts, the queries, radii and cell_size read,
    D/I/neighbor_num written) over HBM bandwidth, and its f32 operations
    (8 per filled candidate in each query's stencil) over the f32 peak."""
    from loopy_slam_torch.ops import knn

    nbytes, ops = knn.query_cost(grid, queries, k, per_query_radius)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


# the plain version materializes (Q, 27*M, 4) float32 candidates; above
# this many bytes it runs in chunks of queries (the same outputs)
PLAIN_CHUNK_BYTES = 4 << 30


def plain_query(grid, q, k, r):
    """knn._query_plain over q, in chunks of queries when its candidate
    rows would pass PLAIN_CHUNK_BYTES; r is a float or a (Q,) tensor."""
    import torch

    from loopy_slam_torch.ops import knn

    row_bytes = 27 * grid.cell_data.shape[1] * 16
    chunk = max(PLAIN_CHUNK_BYTES // row_bytes, 1)
    Q = q.shape[0]
    if Q <= chunk:
        return knn._query_plain(grid, q, k, r)
    per_query = isinstance(r, torch.Tensor)
    outs = [knn._query_plain(grid, q[s:s + chunk], k,
                             r[s:s + chunk] if per_query else r)
            for s in range(0, Q, chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def check_shape(name, grid, q, k, r, variant_libs=None):
    """The kernel against its plain version on one shape (bit-equal D, I
    and neighbor_num, by the wrapper and by a bare launch), its times and
    its bound; raises on any disagreement. r: the query radius, a float or
    a (Q,) tensor of per-query radii."""
    import torch

    from loopy_slam_torch.ops import knn

    M = grid.cell_data.shape[1]
    D, I, nn = knn._query_cuda(grid, q, k, r)
    Dp, Ip, nnp = plain_query(grid, q, k, r)
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
    plain_ms = time_cuda(lambda: plain_query(grid, q, k, r))
    per_query = isinstance(r, torch.Tensor)
    bound_ms, bound_by, nbytes, ops = knn_bound(grid, q, k, per_query)
    res = {"shape": name, "Q": int(q.shape[0]), "M": int(M),
           "radius": "per query" if per_query else float(r),
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


# a share of a peak above this means the count is wrong
ROOFLINE_SHARE_MAX = 1.05


def counter_backward_check(device):
    """utils/cost.CostCounter sees autograd's backward on the card (the
    engine runs CUDA backward on a thread of its own): a Linear's forward
    and backward read 3x its forward product. Raises otherwise."""
    import torch

    from loopy_slam_torch.utils.cost import CostCounter

    lin = torch.nn.Linear(128, 128).to(device)
    x = torch.randn(4096, 128, device=device, requires_grad=True)
    with CostCounter() as fwd:
        lin(x)
    with CostCounter() as both:
        y = lin(x)
        torch.autograd.grad(y.sum(), [x, *lin.parameters()])
    torch.cuda.synchronize()
    res = {"forward_products": fwd.products,
           "forward_backward_products": both.products}
    if not both.products == 3 * fwd.products > 0:
        raise AssertionError(f"CostCounter missed the backward on the "
                             f"card: {res}")
    return res


def roofline_report(slam, what, extra=None):
    """slam.roofline() beside the times of the frames it counted: achieved
    rates and their shares of the card's f32 and HBM peaks, each count
    over its own frame's wall time (the tracked frame's; the mapped
    frame's, whose count is its two stages' chunks scaled by their
    iterations), with the steady medians beside them and the counter's
    unclassified op names. Prints the `roofline:` line; raises on a count
    that is zero, a share outside (0, ROOFLINE_SHARE_MAX], or a session
    the accounting changed."""
    import numpy as np
    import torch

    from loopy_slam_torch.ops import knn

    traj = slam.estimate_c2w.copy()
    feat = slam.map_state.feat.detach().clone()
    launches = knn.KNN_SELECT_LAUNCHES.count
    t0 = time.perf_counter()
    rl = slam.roofline()
    cost_s = time.perf_counter() - t0
    med = lambda v: float(np.median(v)) if v else None  # noqa: E731
    res = {"path": what, "accounting_s": cost_s,
           "track_median_s": med(slam.timings["track"][1:]),
           "map_median_s": med(slam.timings["map"][1:]), **(extra or {})}
    failures = []
    for name in ("track", "map"):
        f = rl.get(name)
        t = f and f["seconds"]
        if not t:
            failures.append(f"no {name} count or frame time")
            continue
        row = {**f, "tflop_s": f["flops"] / t / 1e12,
               "tb_s": f["bytes"] / t / 1e12,
               "flop_share": f["flops"] / t / PEAK_F32_FLOPS,
               "byte_share": f["bytes"] / t / PEAK_BYTES_S,
               "knn_byte_share": f["knn_bytes"] / max(f["bytes"], 1)}
        res[name] = row
        if not (f["flops"] > 0 and f["bytes"] > 0):
            failures.append(f"{name}: a zero count")
        for key in ("flop_share", "byte_share"):
            if not 0 < row[key] <= ROOFLINE_SHARE_MAX:
                failures.append(f"{name}: {key} {row[key]} outside "
                                f"(0, {ROOFLINE_SHARE_MAX}]")
    res["trajectory_bit_equal"] = bool(np.array_equal(traj,
                                                      slam.estimate_c2w))
    res["features_bit_equal"] = bool(torch.equal(feat, slam.map_state.feat))
    res["launches_unchanged"] = knn.KNN_SELECT_LAUNCHES.count == launches
    print("roofline:", json.dumps(res), flush=True)
    for key in ("trajectory_bit_equal", "features_bit_equal",
                "launches_unchanged"):
        if not res[key]:
            failures.append(f"the accounting changed the session ({key})")
    if failures:
        raise AssertionError(f"{what} roofline: " + "; ".join(failures))
    return res


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
    slam, result, summary = run_session(cfg, device)
    print("slice:", json.dumps(summary), flush=True)
    gate_session(summary, result, "the slice-1 path")
    roofline_report(slam, "slice-1",
                    {"backward_check": counter_backward_check(device)})
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


# cut from 31 frames (stop 15), then 21 (stop 10), so that the whole
# script with the Replica and ScanNet paths stays near 1000 s on the card
CLI_FRAMES = 11
CLI_STOP = 5
CLI_VIS_FREQ = 5
# the JAX package's own gates on its final evaluation of the synthetic room
# (tests/test_final_eval.py): psnr > 12 dB, accuracy < 15 cm, completion
# ratio > 20 %
PSNR_GATE = 12.0
ACCURACY_GATE_CM = 15.0
COMPLETION_RATIO_GATE = 20.0


# the visualizer's JPEG of a rendered frame, decoded, against the six
# panels it was made from (4:2:0 at utils/visualizer.JPEG_QUALITY;
# tests/test_torch_eval.py: 30.2 dB on a 60x80 synthetic-room frame with
# noisy residual panels, 33.3 dB at room.yaml's 340x600)
VIS_JPEG_MIN_PSNR_DB = 25.0


def vis_jpeg_check(slam, out):
    """Render the session's last frame through utils/visualizer.Visualizer
    into `out`, decode the JPEG it writes with the port's read_jpeg and
    compare it with six_panels of the same render. Returns {file, shape,
    psnr_db, seconds}."""
    import numpy as np

    from loopy_slam_torch.utils.imageio import read_jpeg
    from loopy_slam_torch.utils.visualizer import Visualizer, six_panels

    t0 = time.perf_counter()
    idx = slam.n_img - 1
    _, color, depth, _ = slam.dataset[idx]
    color, depth = np.asarray(color), np.asarray(depth)
    vis = Visualizer(1, out, slam, verbose=False)
    rendered, rgb = vis.vis(idx, 0, depth, color, slam.estimate_c2w[idx],
                            r_query_map=slam._dynamic_radius(color)[1],
                            freq_override=True)
    path = os.path.join(out, f"{idx:05d}_0000.jpg")
    got = read_jpeg(path).astype(np.float64)
    want = six_panels(depth, rendered, color, rgb)
    mse = float(np.mean((got - want) ** 2)) if got.shape == want.shape \
        else float("inf")
    return {"file": os.path.relpath(path, HERE), "shape": list(got.shape),
            "psnr_db": float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12))),
            "seconds": time.perf_counter() - t0}


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
    """The CLI path: `python -m loopy_slam_torch.run <overlay> --stop
    CLI_STOP`, then `... --resume` in a fresh session (the frames after it,
    color refinement, the final evaluation), with the kernel's launch
    count reset before the first call and read after the second. Returns
    (summary, overlay path)."""
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
    second = cli.main([overlay, "--resume"], after_run=lambda slam:
                      vis_jpeg_check(slam, os.path.join(out, "vis_check")))
    t2 = time.perf_counter()
    launches = knn.KNN_SELECT_LAUNCHES.count
    vis = {d: sorted(f for f in os.listdir(os.path.join(out, d))
                     if f.endswith(".jpg"))
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
        "vis_images": vis_bytes, "vis_jpeg_check": second["after_run"],
        "vis_s": vis_s,
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
    want = {f"{d}/{i:05d}_{cfg[part]['iters'] - 1:04d}.jpg"
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
    check = summary["vis_jpeg_check"]
    if not check["psnr_db"] >= VIS_JPEG_MIN_PSNR_DB:
        failures.append(f"the visualizer's JPEG decodes {check['psnr_db']} "
                        f"dB from its panels, < {VIS_JPEG_MIN_PSNR_DB}")
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


def checkpoint_grid(cfg, ck, device):
    """The hash grid of a checkpoint's map, indexed as restore() indexes
    it (build_adaptive at the capacity the growth policy gives)."""
    import numpy as np
    import torch

    from loopy_slam_torch.mapping.point_cloud import MapOptions
    from loopy_slam_torch.ops import knn

    mopts = MapOptions.from_cfg(cfg)
    n = int(ck["map"]["count"])
    cap = min(int(cfg["pointcloud"].get("initial_capacity", 2 ** 15)),
              mopts.capacity)
    while cap < n + 6000:
        cap *= 2
    pos = torch.zeros((cap, 3), device=device)
    pos[:n] = torch.as_tensor(np.asarray(ck["map"]["pos"], np.float32))
    return knn.build_adaptive(pos, torch.arange(cap, device=device) < n,
                              mopts.cell_size, mopts.table_size,
                              mopts.max_per_cell)


def render_chunk_check(overlay, device):
    """The kernel against its plain version at the render-chunk shape: one
    chunk of render_img (4096 rays x N_surface samples, guided by the
    frame's depth) of frame 2 * CLI_STOP at its estimated pose, over the
    CLI path's final map, indexed as restore() indexes it."""
    import numpy as np
    import torch

    from loopy_slam_torch import run as cli
    from loopy_slam_torch.config import load_config
    from loopy_slam_torch.ops.camera import get_rays
    from loopy_slam_torch.ops.sampling import pixels_to_points, surface_z_vals
    from loopy_slam_torch.utils.datasets import Synthetic
    from loopy_slam_torch.utils.io import load_checkpoint

    print("== phase 6b: knn_select at the render-chunk shape", flush=True)
    cfg = load_config(overlay)
    ck = load_checkpoint(cli.latest_checkpoint(cfg["data"]["output"]))
    grid = checkpoint_grid(cfg, ck, device)
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


def dataset_overlay(out: str, base_yaml: str, fixture: str,
                    vis_freq: int, mapping=None) -> str:
    """A config overlay of a shipped dataset YAML that changes only the
    input folder, the output directory, both vis_freq and the `mapping`
    entries given. Returns its path."""
    path = os.path.join(out, os.path.basename(base_yaml))
    with open(path, "w") as f:
        f.write(f"inherit_from: {json.dumps(base_yaml)}\n"
                f"data: {{input_folder: {json.dumps(fixture)}, "
                f"output: {json.dumps(out)}}}\n"
                f"tracking: {{vis_freq: {vis_freq}}}\n"
                f"mapping: "
                f"{json.dumps({'vis_freq': vis_freq, **(mapping or {})})}\n")
    return path


def run_dataset_path(overlay, out, after_run=None):
    """`python -m loopy_slam_torch.run` (its `main`, with after_run) on
    overlay, with the kernel's launch count reset just before and read just
    after; the session's stats plus launches, run seconds, peak device
    memory, the final mesh's face count and the visualizer's JPEGs."""
    import torch

    from loopy_slam_torch import run as cli
    from loopy_slam_torch.ops import knn
    from loopy_slam_torch.utils.io import read_ply_mesh

    knn.KNN_SELECT_LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = cli.main([overlay], after_run=after_run)
    run_s = time.perf_counter() - t0
    launches = knn.KNN_SELECT_LAUNCHES.count
    mesh_path = os.path.join(out, "mesh", "final_mesh.ply")
    n_faces = (len(read_ply_mesh(mesh_path)[1])
               if os.path.exists(mesh_path) else 0)
    vis = sorted(f"{d}/{f}" for d in ("tracking_vis", "mapping_vis")
                 if os.path.isdir(os.path.join(out, d))
                 for f in os.listdir(os.path.join(out, d))
                 if f.endswith(".jpg"))
    return stats, {"knn_select_launches": launches, "run_s": run_s,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "mesh_faces": n_faces, "vis_images": vis}


def session_summary(stats, extra):
    """The phase-time and metric fields the dataset paths share."""
    import numpy as np

    t = stats["timings_s"]
    med = lambda v: float(np.median(v)) if v else None  # noqa: E731
    return {
        "track_median_s": med(t.get("track")),
        "map_median_s": med(t.get("map")), "map_times_s": t.get("map"),
        "color_refine_s": (t.get("color_refine") or [None])[-1],
        "vis_median_s": med(t.get("vis")),
        "eval_timings_s": stats.get("eval_timings_s"),
        "eval_error": stats.get("eval_error"),
        "psnr": stats.get("psnr"), "depth_l1": stats.get("depth_l1"),
        "ate_rmse_m": stats["rmse"],
        "ate_rmse_noalign_m": stats["rmse_no_align"],
        "ate_frames": stats["n"],
        "health_rejects": stats["health_rejects"],
        "segments": stats["segments"], "n_points": stats["n_points"],
        **extra}


TUM_FRAMES = 16
TUM_VIS_FREQ = 6
# the JAX package's band for its tiny TUM-format fixture session is 6 cm
# (tests/test_sensor_fixtures.py); at full width the card's runs measured
# 5.4-5.5 mm, so the gate is 2 cm: ~3.6x that, while a session that loses
# track ends decimeters off (PERF.md)
TUM_ATE_GATE_M = 0.02
TUM_MIN_FRAMES = 10


def host_frame_costs(ds):
    """Per-frame host seconds of the loader's two costs on the sequence:
    PNG decoding (color and depth) and undistortion (the remap, its map
    made once), and the map's one-off seconds."""
    from loopy_slam_torch.utils.datasets import as_intrinsics_matrix
    from loopy_slam_torch.utils.imageio import (read_png, remap_linear,
                                                undistort_map)

    png_s, und_s = [], []
    t0 = time.perf_counter()
    color = read_png(ds.color_paths[0])
    taps = undistort_map(as_intrinsics_matrix([ds.fx, ds.fy, ds.cx, ds.cy]),
                         ds.distortion, *color.shape[:2])
    map_s = time.perf_counter() - t0
    for cp, dp in zip(ds.color_paths, ds.depth_paths):
        t0 = time.perf_counter()
        color = read_png(cp)
        read_png(dp)
        t1 = time.perf_counter()
        remap_linear(color[..., :3], taps)
        und_s.append(time.perf_counter() - t1)
        png_s.append(t1 - t0)
    return png_s, und_s, map_s


def tum_phase():
    """The TUM path: the port's fixture writer puts a TUM-format sequence
    of the synthetic room in freiburg1's geometry (480x640, its published
    distortion, jittered 30 Hz timestamps, dropped depth frames, zero-depth
    holes) on disk, then `python -m loopy_slam_torch.run` (its `main`)
    runs freiburg1_desk.yaml as shipped on it, with the kernel's launch
    count reset just before and read just after. Returns (summary,
    overlay path)."""
    import shutil

    import numpy as np

    from loopy_slam_torch.config import load_config
    from loopy_slam_torch.ops.image import dynamic_radius_maps
    from loopy_slam_torch.tools.make_sensor_fixtures import write_tum
    from loopy_slam_torch.utils.datasets import get_dataset

    print(f"== phase 8: the TUM path, freiburg1_desk.yaml on a "
          f"{TUM_FRAMES}-frame TUM-format sequence", flush=True)
    out = os.path.join(HERE, "output", "chip_smoke_tum")
    shutil.rmtree(out, ignore_errors=True)
    fixture = os.path.join(out, "sequence")
    t0 = time.perf_counter()
    written = write_tum(fixture, TUM_FRAMES, 1.0 / 200.0)
    fixture_s = time.perf_counter() - t0
    overlay = dataset_overlay(
        out, os.path.join(HERE, "configs", "TUM_RGBD",
                          "freiburg1_desk.yaml"), fixture, TUM_VIS_FREQ,
        mapping={"color_refine": False})
    stats, extra = run_dataset_path(
        overlay, out, after_run=lambda slam: roofline_report(slam, "tum"))

    cfg = load_config(overlay)
    ds = get_dataset(cfg)
    pc = cfg["pointcloud"]
    rq = np.concatenate([dynamic_radius_maps(
        ds[i][1], pc["radius_add_max"], pc["radius_add_min"],
        pc["radius_query_ratio"], pc["color_grad_threshold"])[1].ravel()
        for i in range(len(ds))])
    png_s, und_s, map_s = host_frame_costs(ds)
    g = stats["grad_stats"]
    med = lambda v: float(np.median(v)) if v else None  # noqa: E731
    summary = session_summary(stats, {
        **extra, "frames_written": TUM_FRAMES, "rgb_files": written["rgb"],
        "depth_files": written["depth"], "frames_associated": len(ds),
        "crop_hw": list(ds[0][1].shape[:2]),
        "r_query_median": float(np.median(rq)),
        "r_query_min": float(rq.min()), "r_query_max": float(rq.max()),
        "track_grad_pool_median": med(g["track_pool"]),
        "track_grad_pool_min": min(g["track_pool"], default=None),
        "grad_insert_locations": g["map_locations"],
        "grad_insert_points": sum(g["map_locations"]) * pc["N_add"],
        "png_decode_s_per_frame": med(png_s),
        "undistort_s_per_frame": med(und_s), "undistort_map_s": map_s,
        "fixture_write_s": fixture_s})
    print("tum:", json.dumps(summary), flush=True)
    failures = []
    if summary["frames_associated"] < TUM_MIN_FRAMES:
        failures.append(f"{summary['frames_associated']} frames associated "
                        f"< {TUM_MIN_FRAMES}")
    if not summary["ate_rmse_m"] < TUM_ATE_GATE_M:
        failures.append(f"ATE {summary['ate_rmse_m']} m not < "
                        f"{TUM_ATE_GATE_M} m")
    if summary["health_rejects"]:
        failures.append(f"{summary['health_rejects']} health-gate rejects")
    if summary["grad_insert_points"] <= 0:
        failures.append("the color-gradient picks inserted no point")
    if summary["mesh_faces"] <= 0:
        failures.append("final_mesh.ply has no faces")
    if summary["eval_error"]:
        failures.append(f"the final evaluation failed: "
                        f"{summary['eval_error']}")
    if summary["knn_select_launches"] <= 0:
        failures.append("the TUM path never launched the knn_select kernel")
    if failures:
        raise AssertionError("the TUM path: " + "; ".join(failures))
    return summary, overlay


def radius_pool_queries(views, per_frame, cam, rcfg, gen, pools=None):
    """Sample positions and their per-query radii shaped like the main
    path's pools with the dynamic radius: per_frame pixels of each view
    (color, depth, c2w, r_query map) -- uniform, or drawn from the view's
    pool of flat pixel indices (the tracker's color-gradient picks) --
    with N_surface depth-guided samples per ray, each with its ray's
    radius. The pool's z-values use the inside gate over all its rays, as
    the mapper's pool does."""
    import torch

    from loopy_slam_torch.ops.camera import rays_from_uv
    from loopy_slam_torch.ops.sampling import (inside_mask_from_depth,
                                               surface_z_vals)

    S = rcfg["N_surface"]
    rays, ds, rqs = [], [], []
    for n, (_, depth, c2w, rq) in enumerate(views):
        H, W = depth.shape
        dev = depth.device
        if pools is None:
            j = torch.randint(0, H, (per_frame,), generator=gen, device=dev)
            i = torch.randint(0, W, (per_frame,), generator=gen, device=dev)
        else:
            pool = pools[n]
            flat = pool[torch.randint(0, pool.numel(), (per_frame,),
                                      generator=gen, device=dev)]
            j, i = flat // W, flat % W
        ro, rd = rays_from_uv(i.float(), j.float(), c2w, cam["fx"],
                              cam["fy"], cam["cx"], cam["cy"])
        rays.append((ro, rd))
        ds.append(depth[j, i])
        rqs.append(rq[j, i])
    d = torch.cat(ds)
    z = surface_z_vals(d, inside_mask_from_depth(d, d > 0), S,
                       rcfg["near_end_surface"], rcfg["far_end_surface"],
                       rcfg["near_end"])
    ro = torch.cat([r[0] for r in rays])
    rd = torch.cat([r[1] for r in rays])
    q = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
    r = torch.repeat_interleave(torch.cat(rqs), S)
    return q.contiguous(), r.contiguous()


def tum_kernel_check(overlay, device):
    """The kernel against its plain version at the TUM path's two new
    shapes, both with per-query radii, over that path's final map (the
    dynamic radius's 0.16 m cells, M >= 64): the tracking pool
    (pool_factor x pixels rays drawn from the last frame's color-gradient
    pool, at its estimated pose) and a mapping pool (pixel_pool_factor x
    pixels / window rays of each of the window's frames, the last mapped
    frames at their estimated poses)."""
    import torch

    from loopy_slam_torch import run as cli
    from loopy_slam_torch.config import load_config
    from loopy_slam_torch.slam import update_cam
    from loopy_slam_torch.utils.datasets import get_dataset
    from loopy_slam_torch.utils.io import load_checkpoint

    print("== phase 8b: knn_select at the TUM pools, per-query radii",
          flush=True)
    cfg = load_config(overlay)
    ck = load_checkpoint(cli.latest_checkpoint(cfg["data"]["output"]))
    grid = checkpoint_grid(cfg, ck, device)
    ds = get_dataset(cfg)
    m = cfg["mapping"]
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    last = len(ds) - 1
    q, r = track_pool_queries(cfg, ck, ds, device, gen, last)
    k = cfg["pointcloud"]["nn_num"]
    M, T = grid.cell_data.shape[1], grid.cell_data.shape[0] - 1
    results = [check_shape(f"tum_track_pool Q={q.shape[0]} M={M} T={T}",
                           grid, q, k, r)]
    # the mapper pads its window to mapping_window_size frames by repeats
    window = m["mapping_window_size"]
    mapped = list(range(last, -1, -m["every_frame"]))
    frames = [mapped[i % len(mapped)] for i in range(window)]
    per_frame = m.get("pixel_pool_factor", 8) * max(m["pixels"] // window, 1)
    q, r = radius_pool_queries(
        [frame_view(cfg, ck, ds, device, i) for i in frames], per_frame,
        update_cam(cfg), cfg["rendering"], gen)
    results.append(check_shape(
        f"tum_map_pool Q={q.shape[0]} F={len(frames)} M={M} T={T}", grid,
        q, k, r))
    return results


def track_pool_queries(cfg, ck, ds, device, gen, idx):
    """The tracking pool of frame idx at its estimated pose: pool_factor x
    pixels rays drawn from the frame's color-gradient pool (with
    tracking.sample_with_color_grad; else from the frame inside the ignored
    edges), N_surface samples each, with their per-query radii (the frame's
    r_query map with the dynamic radius, else pointcloud.radius_query)."""
    import numpy as np
    import torch

    from loopy_slam_torch.ops.image import select_pixels_by_grad
    from loopy_slam_torch.slam import update_cam

    cam = update_cam(cfg)
    t = cfg["tracking"]
    view = frame_view(cfg, ck, ds, device, idx)
    if t["sample_with_color_grad"]:
        flat, _ = select_pixels_by_grad(
            t["ignore_edge_H"], cam["H"] - t["ignore_edge_H"],
            t["ignore_edge_W"], cam["W"] - t["ignore_edge_W"], t["pixels"],
            view[0], gt_depth=view[1].cpu().numpy(),
            depth_limit=t["depth_limit"])
    else:
        jj, ii = np.mgrid[t["ignore_edge_H"]:cam["H"] - t["ignore_edge_H"],
                          t["ignore_edge_W"]:cam["W"] - t["ignore_edge_W"]]
        flat = (jj * cam["W"] + ii).ravel()
    n_track = t["pixels"] * t.get("pool_factor", 4)
    return radius_pool_queries(
        [view], n_track, cam, cfg["rendering"], gen,
        pools=[torch.as_tensor(flat, device=device)])


def frame_view(cfg, ck, ds, device, i):
    """Frame i of the dataset on the card at its estimated pose in the
    checkpoint ck: (color numpy, depth, c2w, r_query map), the query radius
    map from the frame's color gradient with the dynamic radius, else
    pointcloud.radius_query everywhere."""
    import numpy as np
    import torch

    from loopy_slam_torch.ops.image import dynamic_radius_maps

    pc = cfg["pointcloud"]
    _, color, depth, _ = ds[i]
    if cfg["use_dynamic_radius"]:
        _, rq = dynamic_radius_maps(
            color, pc["radius_add_max"], pc["radius_add_min"],
            pc["radius_query_ratio"], pc["color_grad_threshold"])
    else:
        rq = np.full(depth.shape, pc["radius_query"], np.float32)
    pose = np.asarray(ck["estimate_c2w_list"][i], np.float32)
    return (color, torch.as_tensor(depth, device=device),
            torch.as_tensor(pose, device=device),
            torch.as_tensor(rq, device=device))


def jpeg_frame_costs(ds):
    """Per-frame host seconds of the JPEG loaders' costs: read_jpeg on the
    color file, read_png on the depth file, and resize_linear of the color
    to depth's size (None where the sizes agree)."""
    import numpy as np

    from loopy_slam_torch.utils.imageio import (read_jpeg, read_png,
                                                resize_linear)

    jpg_s, png_s, resize_s = [], [], []
    for cp, dp in zip(ds.color_paths, ds.depth_paths):
        t0 = time.perf_counter()
        color = read_jpeg(cp)
        t1 = time.perf_counter()
        depth = read_png(dp)
        t2 = time.perf_counter()
        jpg_s.append(t1 - t0)
        png_s.append(t2 - t1)
        if color.shape[:2] != depth.shape:
            c = color.astype(np.float32) / 255.0
            t0 = time.perf_counter()
            resize_linear(c, depth.shape[::-1])
            resize_s.append(time.perf_counter() - t0)
    med = lambda v: float(np.median(v)) * 1e3 if v else None  # noqa: E731
    return med(jpg_s), med(png_s), med(resize_s)


# the Replica path: configs/Replica/room0.yaml as shipped on a sequence of
# the synthetic room at Replica's 680x1200 geometry, written at the
# Synthetic default of 0.004 a frame (~1.1 cm, Replica-like); cut to 6
# frames (mapped frames 0 and 5) and color refinement off (49-95 s of the
# phase on an H100, for the time of phase 12; the segmented, CLI, TUM and
# ScanNet paths keep it). Gates: the room paths' band is <= 3 mm, so < 1 cm
# still fails a session that loses track (decimeters off)
REPLICA_FRAMES = 6
REPLICA_SPEED = 0.004
REPLICA_VIS_FREQ = 5
REPLICA_ATE_GATE_M = 0.01
PSNR_GATE_DB = 12.0


def replica_phase():
    """The Replica path: the port's writer puts a Replica-format sequence
    (680x1200 JPEG color at quality 92, 16-bit depth, traj.txt) on disk,
    then the CLI runs room0.yaml as shipped on it. Returns (summary,
    overlay path)."""
    import shutil

    from loopy_slam_torch.config import load_config
    from loopy_slam_torch.tools.make_sensor_fixtures import write_replica
    from loopy_slam_torch.utils.datasets import get_dataset

    print(f"== phase 9: the Replica path, room0.yaml on a "
          f"{REPLICA_FRAMES}-frame Replica-format sequence", flush=True)
    out = os.path.join(HERE, "output", "chip_smoke_replica")
    shutil.rmtree(out, ignore_errors=True)
    fixture = os.path.join(out, "sequence")
    t0 = time.perf_counter()
    write_replica(fixture, REPLICA_FRAMES, REPLICA_SPEED)
    fixture_s = time.perf_counter() - t0
    overlay = dataset_overlay(
        out, os.path.join(HERE, "configs", "Replica", "room0.yaml"),
        fixture, REPLICA_VIS_FREQ, mapping={"color_refine": False})
    stats, extra = run_dataset_path(overlay, out)
    ds = get_dataset(load_config(overlay))
    jpg_ms, png_ms, _ = jpeg_frame_costs(ds)
    summary = session_summary(stats, {
        **extra, "frames": len(ds), "hw": list(ds[0][1].shape[:2]),
        "read_jpeg_ms_per_frame": jpg_ms,
        "depth_png_ms_per_frame": png_ms, "fixture_write_s": fixture_s})
    print("replica:", json.dumps(summary), flush=True)
    failures = []
    if not summary["ate_rmse_m"] < REPLICA_ATE_GATE_M:
        failures.append(f"ATE {summary['ate_rmse_m']} m not < "
                        f"{REPLICA_ATE_GATE_M} m")
    if summary["health_rejects"]:
        failures.append(f"{summary['health_rejects']} health-gate rejects")
    if extra["knn_select_launches"] <= 0:
        failures.append("the Replica path never launched the knn_select "
                        "kernel")
    if not (summary["psnr"] or 0) > PSNR_GATE_DB:
        failures.append(f"psnr {summary['psnr']} not > {PSNR_GATE_DB}")
    if extra["mesh_faces"] <= 0:
        failures.append("final_mesh.ply has no faces")
    if summary["eval_error"]:
        failures.append(f"the final evaluation failed: "
                        f"{summary['eval_error']}")
    if failures:
        raise AssertionError("the Replica path: " + "; ".join(failures))
    return summary, overlay


def replica_kernel_check(overlay, device):
    """The kernel against its plain version at Replica's mapping pool over
    that path's final map: pixel_pool_factor x pixels / window rays of each
    of the window's frames (the mapped frames, repeated to
    mapping_window_size as the mapper pads), N_surface samples each, at
    the scalar radius."""
    import torch

    from loopy_slam_torch import run as cli
    from loopy_slam_torch.config import load_config
    from loopy_slam_torch.slam import update_cam
    from loopy_slam_torch.utils.datasets import get_dataset
    from loopy_slam_torch.utils.io import load_checkpoint

    print("== phase 9b: knn_select at Replica's mapping pool", flush=True)
    cfg = load_config(overlay)
    ck = load_checkpoint(cli.latest_checkpoint(cfg["data"]["output"]))
    grid = checkpoint_grid(cfg, ck, device)
    ds = get_dataset(cfg)
    m, pc = cfg["mapping"], cfg["pointcloud"]
    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    window = m["mapping_window_size"]
    mapped = list(range(len(ds) - 1, -1, -m["every_frame"]))
    frames = [mapped[i % len(mapped)] for i in range(window)]
    per_frame = m.get("pixel_pool_factor", 8) * max(m["pixels"] // window, 1)
    q, _ = radius_pool_queries(
        [frame_view(cfg, ck, ds, device, i) for i in frames], per_frame,
        update_cam(cfg), cfg["rendering"], gen)
    M, T = grid.cell_data.shape[1], grid.cell_data.shape[0] - 1
    return check_shape(
        f"replica_map_pool Q={q.shape[0]} F={len(frames)} M={M} T={T}",
        grid, q, pc["nn_num"], pc["radius_query"])


# the ScanNet path: configs/ScanNet/scene0000.yaml as shipped on a
# ScanNet-format sequence (1296x968 JPEG color at quality 90 with a
# per-frame exposure gain and tint, 640x480 depth with holes), cut to 6
# frames (mapped frames 0 and 5; 11 in a first card run, cut for time). The
# writer's seed draws which frames carry an inf ground-truth pose
# (max(frames // 200, 1) of them, frames 0 and 1 excepted); with 6 frames
# its default seed 11 draws frame 0, so no pose would be inf; seed 0 draws
# frame 5, the last mapped frame
SCANNET_FRAMES = 6
SCANNET_SEED = 0
SCANNET_SPEED = 1.0 / 200.0
SCANNET_VIS_FREQ = 5
SCANNET_ATE_GATE_M = 0.02


def scannet_phase():
    """The ScanNet path: the port's writer puts a ScanNet-format sequence
    on disk, then the CLI runs scene0000.yaml as shipped on it (exposure
    compensation, the dynamic radius, the color-gradient tracking pool,
    crop_edge 10). Returns (summary, overlay path)."""
    import shutil

    import numpy as np

    from loopy_slam_torch.config import load_config
    from loopy_slam_torch.tools.make_sensor_fixtures import write_scannet
    from loopy_slam_torch.utils.datasets import get_dataset
    from loopy_slam_torch.utils.io import load_checkpoint

    print(f"== phase 10: the ScanNet path, scene0000.yaml on a "
          f"{SCANNET_FRAMES}-frame ScanNet-format sequence", flush=True)
    out = os.path.join(HERE, "output", "chip_smoke_scannet")
    shutil.rmtree(out, ignore_errors=True)
    fixture = os.path.join(out, "sequence")
    t0 = time.perf_counter()
    written = write_scannet(fixture, SCANNET_FRAMES, SCANNET_SPEED,
                            seed=SCANNET_SEED)
    fixture_s = time.perf_counter() - t0
    overlay = dataset_overlay(
        out, os.path.join(HERE, "configs", "ScanNet", "scene0000.yaml"),
        fixture, SCANNET_VIS_FREQ)
    stats, extra = run_dataset_path(overlay, out)
    cfg = load_config(overlay)
    ds = get_dataset(cfg)
    jpg_ms, png_ms, resize_ms = jpeg_frame_costs(ds)
    from loopy_slam_torch import run as cli

    r = load_checkpoint(cli.latest_checkpoint(out))["resume"]
    ef = np.asarray(r["exposure_feat"], np.float64)
    every = cfg["mapping"]["every_frame"]
    mapped = sorted({*range(0, len(ds), every), len(ds) - 1})
    cd_dir = os.path.join(out, "ckpts", "color_decoder")
    snaps = sorted(os.listdir(cd_dir)) if os.path.isdir(cd_dir) else []
    summary = session_summary(stats, {
        **extra, "frames": len(ds), "crop_hw": list(ds[0][1].shape[:2]),
        "inf_gt_poses": written["bad_poses"],
        "gt_poses_masked": len(ds) - stats["n"],
        "exposure_latent_norm": float(np.linalg.norm(ef)),
        "exposure_latent_finite": bool(np.isfinite(ef).all()),
        "mapped_exposure_frames": sorted(r["mapped_exposure"]),
        "color_decoder_snapshots": snaps,
        "read_jpeg_ms_per_frame": jpg_ms,
        "depth_png_ms_per_frame": png_ms,
        "resize_linear_ms_per_frame": resize_ms,
        "fixture_write_s": fixture_s})
    print("scannet:", json.dumps(summary), flush=True)
    failures = []
    if not written["bad_poses"] or summary["gt_poses_masked"] < 1:
        failures.append("no inf ground-truth pose was masked")
    if not summary["ate_rmse_m"] < SCANNET_ATE_GATE_M:
        failures.append(f"ATE {summary['ate_rmse_m']} m not < "
                        f"{SCANNET_ATE_GATE_M} m")
    if summary["health_rejects"]:
        failures.append(f"{summary['health_rejects']} health-gate rejects")
    if extra["knn_select_launches"] <= 0:
        failures.append("the ScanNet path never launched the knn_select "
                        "kernel")
    if not (summary["exposure_latent_finite"]
            and summary["exposure_latent_norm"] > 0):
        failures.append(f"exposure latent {ef.tolist()} not finite and "
                        "non-zero")
    if snaps != [f"{i:05d}.pkl" for i in mapped] \
            or summary["mapped_exposure_frames"] != mapped:
        failures.append(f"color-decoder snapshots {snaps} / mapped latents "
                        f"{summary['mapped_exposure_frames']}, expected one "
                        f"per mapped frame {mapped}")
    if not (summary["psnr"] or 0) > PSNR_GATE_DB:
        failures.append(f"psnr {summary['psnr']} not > {PSNR_GATE_DB}")
    if summary["eval_error"]:
        failures.append(f"the final evaluation failed: "
                        f"{summary['eval_error']}")
    if failures:
        raise AssertionError("the ScanNet path: " + "; ".join(failures))
    return summary, overlay


def scannet_kernel_check(overlay, device):
    """The kernel against its plain version at ScanNet's tracking pool,
    with per-query radii, over that path's final map: pool_factor x pixels
    rays from the last frame's color-gradient pool at its estimated
    pose."""
    import torch

    from loopy_slam_torch import run as cli
    from loopy_slam_torch.config import load_config
    from loopy_slam_torch.utils.datasets import get_dataset
    from loopy_slam_torch.utils.io import load_checkpoint

    print("== phase 10b: knn_select at ScanNet's tracking pool, per-query "
          "radii", flush=True)
    cfg = load_config(overlay)
    ck = load_checkpoint(cli.latest_checkpoint(cfg["data"]["output"]))
    grid = checkpoint_grid(cfg, ck, device)
    ds = get_dataset(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(10)
    q, r = track_pool_queries(cfg, ck, ds, device, gen, len(ds) - 1)
    M, T = grid.cell_data.shape[1], grid.cell_data.shape[0] - 1
    return check_shape(f"scannet_track_pool Q={q.shape[0]} M={M} T={T}",
                       grid, q, cfg["pointcloud"]["nn_num"], r)


# the base-config path: freiburg1_desk.yaml on phase 8's sequence with the
# three tracking and mapping options of configs/point_slam.yaml's reference
# that no shipped dataset YAML turns on: sample_near_pcl (the base YAML's
# default), bundle adjustment and the visual odometer (the motion model
# only without const_speed_assumption). Widths as shipped (5000 tracking
# pixels, 10000 mapping pixels over a window of 10, 480x640, nn_num 8).
# Depth cuts, for a phase of ~90 s: keyframe_every 2 (5), so that BA
# (more than 4 keyframes) turns on within the sequence, as the JAX
# package's own BA test sets it; submaps off (a segment restarts the local
# keyframe list, which BA counts; phases 5, 6 and 8-10 hold submaps);
# color refinement, the final evaluation and the visualizer off (five
# earlier paths hold them); 100 tracking iterations (200) and 500 first /
# 100 mapping iterations (1500 / 300): without the k-NN cache and the ray
# pool every iteration runs its own k-NN and its probe, and the odometer
# takes ~2 s a frame (on an NVIDIA H100 80GB HBM3 at 700 W these made a
# 63-67 s phase ending 6 mm off; 300 / 60 mapping iterations ended 10-13
# mm off, near the 2 cm gate)
BASE_OVERRIDES = {
    "rendering": {"sample_near_pcl": True, "eval_img": False},
    "tracking": {"visual_odometer": True, "const_speed_assumption": False,
                 "iters": 100, "vis_freq": 0},
    "mapping": {"BA": True, "keyframe_every": 2, "every_frame": 2,
                "segment_strategy": "none", "color_refine": False,
                "iters_first": 500, "iters": 100, "vis_freq": 0},
    "meshing": {"eval_rec": False},
}
BASE_MIN_BA_FRAMES = 2
# the JAX package's own floor for its fixture's holes
# (tests/test_sensor_fixtures.py)
BASE_MIN_ZERO_DEPTH = 0.005


def base_phase(device):
    """The base-config path: `python -m loopy_slam_torch.run` (its main)
    on an overlay of freiburg1_desk.yaml (BASE_OVERRIDES) over phase 8's
    TUM-format sequence, with the kernel's launch count reset just before
    and read just after; then the last frame rendered at its estimate
    through the restored map, its zero-depth pixels by the probe. Returns
    (summary, overlay path)."""
    import shutil

    import numpy as np

    from loopy_slam_torch import run as cli
    from loopy_slam_torch.config import load_config
    from loopy_slam_torch.slam import LoopySLAM
    from loopy_slam_torch.utils.datasets import get_dataset
    from loopy_slam_torch.utils.io import load_checkpoint

    fixture = os.path.join(HERE, "output", "chip_smoke_tum", "sequence")
    if not os.path.isdir(fixture):  # --base-runs: phase 8 did not run
        from loopy_slam_torch.tools.make_sensor_fixtures import write_tum

        write_tum(fixture, TUM_FRAMES, 1.0 / 200.0)
    print("== phase 11: the base-config path, freiburg1_desk.yaml with "
          "sample_near_pcl, BA and the visual odometer on phase 8's "
          "sequence", flush=True)
    out = os.path.join(HERE, "output", "chip_smoke_base")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    overlay = os.path.join(out, "base.yaml")
    with open(overlay, "w") as f:
        f.write("inherit_from: " + json.dumps(os.path.join(
            HERE, "configs", "TUM_RGBD", "freiburg1_desk.yaml")) + "\n")
        f.write("data: " + json.dumps({"input_folder": fixture,
                                        "output": out}) + "\n")
        for k, v in BASE_OVERRIDES.items():
            f.write(f"{k}: {json.dumps(v)}\n")
    t_phase = time.perf_counter()
    stats, extra = run_dataset_path(overlay, out)

    cfg = load_config(overlay)
    ds = get_dataset(cfg)
    zero_share = float(np.mean([np.mean(ds[i][2] == 0)
                                for i in range(len(ds))]))
    ckpt = cli.latest_checkpoint(out)
    ck = load_checkpoint(ckpt)
    est = np.asarray(ck["estimate_c2w_list"])
    kf_moved = sorted(int(i) for i, p in ck["keyframe_est_c2w"].items()
                      if np.linalg.norm(p[:3, 3] - est[i][:3, 3]) > 1e-7)
    odo = stats["timings_s"].get("odometry", [])
    n = stats["n"]
    # the last frame rendered through the restored map: its zero-depth
    # pixels sample where the probe finds the cloud
    slam = LoopySLAM(cfg, output=os.path.join(out, "render"), device=device)
    try:
        slam.restore(ckpt)
        last = len(ds) - 1
        _, _, depth_np, _ = ds[last]
        t0 = time.perf_counter()
        depth, _ = slam.render_img(slam.estimate_c2w[last], depth_np)
        render_s = time.perf_counter() - t0
    finally:
        slam.close()
    holes = depth_np == 0
    filled = holes & np.isfinite(depth) & (depth > 0)
    summary = session_summary(stats, {
        **extra, "frames_associated": len(ds),
        "ba_frames": stats["ba_frames"], "kf_moved_by_ba": kf_moved,
        "odometer_calls": len(odo),
        "odometer_ms_per_call": (float(np.median(odo)) * 1e3
                                 if odo else None),
        "odometer_total_s": float(np.sum(odo)),
        "poses_finite": bool(np.isfinite(est[:n]).all()),
        "zero_depth_share": zero_share,
        "render_hole_pixels": int(holes.sum()),
        "render_hole_pixels_with_depth": int(filled.sum()),
        "render_s": render_s,
        "phase_s": time.perf_counter() - t_phase})
    print("base:", json.dumps(summary), flush=True)
    failures = []
    if not summary["ate_rmse_m"] < TUM_ATE_GATE_M:
        failures.append(f"ATE {summary['ate_rmse_m']} m not < "
                        f"{TUM_ATE_GATE_M} m")
    if summary["health_rejects"]:
        failures.append(f"{summary['health_rejects']} health-gate rejects")
    if summary["knn_select_launches"] <= 0:
        failures.append("the base path never launched the knn_select "
                        "kernel")
    if len(summary["ba_frames"]) < BASE_MIN_BA_FRAMES:
        failures.append(f"BA ran on {len(summary['ba_frames'])} mapped "
                        f"frames < {BASE_MIN_BA_FRAMES}")
    if not kf_moved:
        failures.append("BA moved no keyframe pose by more than 1e-7 m")
    if summary["odometer_calls"] != n - 2 or not summary["poses_finite"]:
        failures.append(f"{summary['odometer_calls']} odometer poses for "
                        f"{n - 2} tracked frames from frame 2, finite "
                        f"{summary['poses_finite']}")
    if zero_share < BASE_MIN_ZERO_DEPTH:
        failures.append(f"zero-depth share {zero_share} < "
                        f"{BASE_MIN_ZERO_DEPTH}")
    if not filled.any():
        failures.append("no zero-depth pixel of the rendered frame got a "
                        "finite depth > 0")
    if failures:
        raise AssertionError("the base-config path: " + "; ".join(failures))
    return summary, overlay


def probe_queries(ro, rd, depth, rcfg):
    """The probe points sample_near_pcl_z_vals_raw queries for these rays
    (25 a ray between near_end and far), far as render_batch_ray sets it
    from the rays' depth-guided samples."""
    import torch

    from loopy_slam_torch.mapping.point_cloud import probe_points
    from loopy_slam_torch.ops.masked import masked_max
    from loopy_slam_torch.ops.sampling import surface_z_vals

    z = surface_z_vals(depth, depth > 0, rcfg["N_surface"],
                       rcfg["near_end_surface"], rcfg["far_end_surface"],
                       rcfg["near_end"])
    far = torch.clamp(masked_max(z[:, -1], depth > 0, fill=0.0), min=1.0)
    return probe_points(ro, rd, rcfg["near_end"], far)[0].contiguous()


def base_kernel_check(overlay, device):
    """The kernel against its plain version at the probe's two shapes over
    the base path's final map, at the scalar radius_query: the tracking
    probes (pixels rays of the last frame's color-gradient pool at its
    estimate, 25 probes each) and a render chunk's probes (4096 rays of
    the last frame's middle, 25 each)."""
    import numpy as np
    import torch

    from loopy_slam_torch import run as cli
    from loopy_slam_torch.config import load_config
    from loopy_slam_torch.ops.camera import get_rays, rays_from_uv
    from loopy_slam_torch.ops.image import select_pixels_by_grad
    from loopy_slam_torch.slam import update_cam
    from loopy_slam_torch.utils.datasets import get_dataset
    from loopy_slam_torch.utils.io import load_checkpoint

    print("== phase 11b: knn_select at the sample_near_pcl probes",
          flush=True)
    cfg = load_config(overlay)
    ck = load_checkpoint(cli.latest_checkpoint(cfg["data"]["output"]))
    grid = checkpoint_grid(cfg, ck, device)
    ds = get_dataset(cfg)
    last = len(ds) - 1
    color, depth, c2w, _ = frame_view(cfg, ck, ds, device, last)
    cam = update_cam(cfg)
    t = cfg["tracking"]
    rcfg = cfg["rendering"]
    k, r = cfg["pointcloud"]["nn_num"], cfg["pointcloud"]["radius_query"]
    M, T = grid.cell_data.shape[1], grid.cell_data.shape[0] - 1
    flat, _ = select_pixels_by_grad(
        t["ignore_edge_H"], cam["H"] - t["ignore_edge_H"],
        t["ignore_edge_W"], cam["W"] - t["ignore_edge_W"], t["pixels"],
        color, gt_depth=depth.cpu().numpy(), depth_limit=t["depth_limit"])
    gen = np.random.default_rng(11)
    pick = torch.as_tensor(gen.choice(flat, t["pixels"]), device=device)
    j, i = pick // cam["W"], pick % cam["W"]
    ro, rd = rays_from_uv(i.float(), j.float(), c2w, cam["fx"], cam["fy"],
                          cam["cx"], cam["cy"])
    q = probe_queries(ro, rd, depth[j, i], rcfg)
    results = [check_shape(f"track_probes Q={q.shape[0]} M={M} T={T}",
                           grid, q, k, r)]
    ro, rd = get_rays(cam["H"], cam["W"], cam["fx"], cam["fy"], cam["cx"],
                      cam["cy"], c2w)
    chunk = 4096
    i0 = (cam["H"] * cam["W"] // 2) // chunk * chunk  # the middle chunk
    q = probe_queries(ro.reshape(-1, 3)[i0:i0 + chunk],
                      rd.reshape(-1, 3)[i0:i0 + chunk],
                      depth.reshape(-1)[i0:i0 + chunk], rcfg)
    results.append(check_shape(f"render_probes Q={q.shape[0]} M={M} T={T}",
                               grid, q, k, r))
    return results


# phase 12, the last inputs and the offline tools. 12a: pretrain_geo at its
# shipped 4 scenes x 400 iterations (the tool's widths: 120x160, 400 pixels
# a frame); the trunk it writes goes to output/, never over
# pretrained/geo_decoder.pkl. Its learning is gated on a room it never saw
# (the seed's next box draw): the geometry loss a pixel after
# HELDOUT_ITERS frozen-trunk geometry iterations from fresh features, as a
# session maps with fix_geo_decoder, with the trained trunk below
# HELDOUT_RATIO_GATE of the initial trunk's.
TOOLS_OUT = os.path.join(HERE, "output", "chip_smoke_tools")
PRETRAIN_SCENES, PRETRAIN_ITERS, PRETRAIN_SEED = 4, 400, 7
HELDOUT_ITERS = 60
HELDOUT_RATIO_GATE = 0.8
# 12b: the Azure Kinect layout through the CLI on configs/point_slam.yaml
# (sample_near_pcl, the dynamic radius, submaps, 200 tracking pixels x 20
# iterations, 1000 mapping pixels over a window of 5, all as shipped) with
# dataset azure, the writer's 720x1280 camera and crop_size 384x512
# (unequal x and y scales), the geometry trunk 12a trained. Depth cuts:
# 6 frames, mapping 500 first / 100 iterations (1500 / 400, as the
# base-config path cuts them), color refinement, the final evaluation and
# the visualizer off.
AZURE_FRAMES = 6
AZURE_SPEED = 1.0 / 200.0
AZURE_CROP = [384, 512]
AZURE_OVERRIDES = {
    "dataset": "azure",
    "tracking": {"vis_freq": 0},
    "mapping": {"iters_first": 500, "iters": 100, "color_refine": False,
                "vis_freq": 0},
    "meshing": {"eval_rec": False},
}
# 12c: CoFusion's layout (PNG color, ZIP EXR depth), loaded only: it has
# no poses, so no ATE to gate a session on
COFUSION_FRAMES = 4
# 12d: mesh video frames, the 72-pose turntable and every 5th pose
MESH_VIDEO_EVERY = 5


def pretrain_phase(device):
    """12a: `python -m loopy_slam_torch.tools.pretrain_geo` (its main)
    with the kernel's launch count reset just before and read just after;
    then the written trunk against the shipped one's layout and its
    initial values, and the held-out check. Returns (summary, trunk
    path)."""
    import pickle

    import numpy as np
    import torch

    from loopy_slam_torch.convert import decoders_to_numpy
    from loopy_slam_torch.models.decoder import init_decoders
    from loopy_slam_torch.ops import knn
    from loopy_slam_torch.slam import _flatten
    from loopy_slam_torch.tools import pretrain_geo

    print(f"== phase 12a: pretrain_geo, {PRETRAIN_SCENES} scenes x "
          f"{PRETRAIN_ITERS} iterations", flush=True)
    os.makedirs(TOOLS_OUT, exist_ok=True)
    out = os.path.join(TOOLS_OUT, "geo.pkl")
    knn.KNN_SELECT_LAUNCHES.reset()
    t0 = time.perf_counter()
    _, scenes = pretrain_geo.main(
        ["--scenes", str(PRETRAIN_SCENES), "--iters", str(PRETRAIN_ITERS),
         "--seed", str(PRETRAIN_SEED), "--out", out])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = knn.KNN_SELECT_LAUNCHES.count
    with open(out, "rb") as f:
        got = dict(_flatten(pickle.load(f)))
    with open(os.path.join(HERE, "pretrained", "geo_decoder.pkl"),
              "rb") as f:
        shipped = dict(_flatten(pickle.load(f)))
    cfg = pretrain_geo.pretrain_config()
    gen = torch.Generator(device=device)
    gen.manual_seed(PRETRAIN_SEED)
    init = decoders_to_numpy(init_decoders(gen, cfg, device=device))
    init_geo = dict(_flatten(init["geo"]))
    moved = max(float(np.abs(got[n] - init_geo[n]).max()) for n in got)
    with open(out, "rb") as f:
        geo = pickle.load(f)
    t0 = time.perf_counter()
    trained_loss = heldout_geo_loss(geo, init["col"], device)
    initial_loss = heldout_geo_loss(init["geo"], init["col"], device)
    heldout_s = time.perf_counter() - t0
    layout_ok = sorted(got) == sorted(shipped) and all(
        got[n].shape == np.asarray(shipped[n]).shape
        and got[n].dtype == np.asarray(shipped[n]).dtype for n in shipped)
    summary = {
        "scenes": scenes, "iters": PRETRAIN_ITERS, "run_s": run_s,
        "s_per_scene": [r["seconds"] for r in scenes],
        "ms_per_iteration": [r["seconds"] / PRETRAIN_ITERS * 1e3
                             for r in scenes],
        "knn_select_launches": launches, "trunk_layout_ok": layout_ok,
        "trunk_finite": all(bool(np.isfinite(a).all()) for a in got.values()),
        "trunk_max_move": moved,
        "heldout_geo_loss_trained": trained_loss,
        "heldout_geo_loss_initial": initial_loss,
        "heldout_ratio": trained_loss / max(initial_loss, 1e-30),
        "heldout_s": heldout_s}
    print("pretrain:", json.dumps(summary), flush=True)
    failures = []
    for s, r in enumerate(scenes):
        if not np.isfinite([r["geo_loss_pixel"], r["color_loss_pixel"]]).all():
            failures.append(f"scene {s}'s loss is not finite: {r}")
    if not layout_ok:
        failures.append("the trunk's keys, shapes or dtypes differ from "
                        "pretrained/geo_decoder.pkl's")
    if not summary["trunk_finite"]:
        failures.append("the trunk has non-finite entries")
    if not moved > 0:
        failures.append("the trunk equals its initial values")
    if not summary["heldout_ratio"] < HELDOUT_RATIO_GATE:
        failures.append(f"held-out geometry loss {trained_loss} with the "
                        f"trained trunk, {initial_loss} with the initial "
                        f"one: ratio not < {HELDOUT_RATIO_GATE}")
    if launches <= 0:
        failures.append("pretrain_geo never launched the knn_select kernel")
    if failures:
        raise AssertionError("phase 12a: " + "; ".join(failures))
    return summary, out


def heldout_geo_loss(geo, col, device):
    """The geometry loss a pixel on a room pretraining did not see (the
    seed's box draw after the trained scenes) after HELDOUT_ITERS
    geometry iterations with the trunk frozen, from fresh features, with
    the same draws for every trunk."""
    import torch

    from loopy_slam_torch.convert import decoders_from_numpy
    from loopy_slam_torch.mapping.mapper import MapperOptions, optimize_map
    from loopy_slam_torch.mapping.point_cloud import valid_mask
    from loopy_slam_torch.models.decoder import trainable_mask
    from loopy_slam_torch.models.renderer import RenderOptions
    from loopy_slam_torch.ops.draws import TorchDraws
    from loopy_slam_torch.tools import pretrain_geo as pg

    cfg = pg.pretrain_config()
    scfg = pg.scene_configs(cfg, PRETRAIN_SCENES + 1, PRETRAIN_SEED)[-1]
    scfg["mapping"]["fix_geo_decoder"] = True
    draw = TorchDraws(123, device)
    state, kc, kd, kp = pg.map_scene(scfg, draw, device)
    dec = decoders_from_numpy({"geo": geo, "col": col}, device,
                              bf16_trunks=cfg["model"]["bf16_trunks"])
    _, _, aux = optimize_map(
        dec, state.feat, None, trainable_mask(dec, scfg), valid_mask(state),
        state.pos, state.grid, kc, kd, kp, draw, HELDOUT_ITERS, 0,
        list(pg.LRS_GEO), list(pg.LRS_COL), MapperOptions.from_cfg(scfg),
        RenderOptions.from_cfg(scfg), pg.PIXELS)
    g, _, n = torch.stack(list(aux)).tolist()
    return g / max(n, 1)


def pretrain_kernel_check(device):
    """The kernel against its plain version at pretrain_geo's mapping pool:
    a map of the last scene by the tool's own insertion (3000 rays of
    every second frame), pixel_pool_factor x 400 rays of each of its 4
    keyframes, N_surface samples each, at the scalar radius_query."""
    import torch

    from loopy_slam_torch.ops.draws import TorchDraws
    from loopy_slam_torch.slam import update_cam
    from loopy_slam_torch.tools import pretrain_geo as pg

    print("== phase 12a': knn_select at pretrain_geo's mapping pool",
          flush=True)
    cfg = pg.pretrain_config()
    scfg = pg.scene_configs(cfg, PRETRAIN_SCENES, PRETRAIN_SEED)[-1]
    state, kc, kd, kp = pg.map_scene(scfg, TorchDraws(12, device), device)
    pc = scfg["pointcloud"]
    views = [(None, kd[f], kp[f], torch.full_like(kd[f], pc["radius_query"]))
             for f in range(kc.shape[0])]
    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    per_frame = scfg["mapping"]["pixel_pool_factor"] * pg.PIXELS
    q, _ = radius_pool_queries(views, per_frame, update_cam(scfg),
                               scfg["rendering"], gen)
    grid = state.grid
    M, T = grid.cell_data.shape[1], grid.cell_data.shape[0] - 1
    return check_shape(
        f"pretrain_map_pool Q={q.shape[0]} F={len(views)} M={M} T={T}",
        grid, q, pc["nn_num"], pc["radius_query"])


def azure_phase(geo_path):
    """12b: the port's writer puts an Azure-layout sequence on disk, then
    the CLI runs configs/point_slam.yaml with dataset azure and crop_size
    on it (AZURE_OVERRIDES), with 12a's trunk. Returns (summary, overlay
    path)."""
    import shutil

    from loopy_slam_torch.config import load_config
    from loopy_slam_torch.tools.make_sensor_fixtures import (AZURE_CAM,
                                                             write_azure)
    from loopy_slam_torch.utils.datasets import get_dataset

    print(f"== phase 12b: the Azure layout with crop_size {AZURE_CROP}, "
          f"point_slam.yaml on {AZURE_FRAMES} frames", flush=True)
    out = os.path.join(HERE, "output", "chip_smoke_azure")
    shutil.rmtree(out, ignore_errors=True)
    fixture = os.path.join(out, "sequence")
    t0 = time.perf_counter()
    write_azure(fixture, AZURE_FRAMES, AZURE_SPEED)
    fixture_s = time.perf_counter() - t0
    overlay = os.path.join(out, "azure.yaml")
    with open(overlay, "w") as f:
        f.write("inherit_from: " + json.dumps(os.path.join(
            HERE, "configs", "point_slam.yaml")) + "\n")
        f.write("data: " + json.dumps({"input_folder": fixture,
                                        "output": out}) + "\n")
        f.write("cam: " + json.dumps({**AZURE_CAM,
                                       "crop_size": AZURE_CROP}) + "\n")
        f.write("pretrained_decoders: "
                + json.dumps({"middle_fine": geo_path}) + "\n")
        for k, v in AZURE_OVERRIDES.items():
            f.write(f"{k}: {json.dumps(v)}\n")
    stats, extra = run_dataset_path(overlay, out)
    ds = get_dataset(load_config(overlay))
    frames = [ds[i] for i in range(len(ds))]
    shapes = sorted({(tuple(c.shape[:2]), tuple(d.shape))
                     for _, c, d, _ in frames})
    summary = session_summary(stats, {
        **extra, "frames": len(ds), "shapes": shapes,
        "loader_ms": azure_frame_costs(ds), "fixture_write_s": fixture_s})
    print("azure:", json.dumps(summary), flush=True)
    failures = []
    if not summary["ate_rmse_m"] < TUM_ATE_GATE_M:
        failures.append(f"ATE {summary['ate_rmse_m']} m not < "
                        f"{TUM_ATE_GATE_M} m")
    if summary["health_rejects"]:
        failures.append(f"{summary['health_rejects']} health-gate rejects")
    if extra["knn_select_launches"] <= 0:
        failures.append("the Azure path never launched the knn_select "
                        "kernel")
    if shapes != [(tuple(AZURE_CROP), tuple(AZURE_CROP))]:
        failures.append(f"loaded frames of shapes {shapes}, not crop_size "
                        f"{AZURE_CROP}")
    if failures:
        raise AssertionError("phase 12b: " + "; ".join(failures))
    return summary, overlay


def azure_frame_costs(ds):
    """Median host ms a frame of the Azure loader's steps: read_jpeg of
    the color, read_png of the depth, and the crop_size resizes
    (resize_linear of the float color, resize_nearest of the depth)."""
    import numpy as np

    from loopy_slam_torch.utils.imageio import (read_jpeg, read_png,
                                                resize_linear,
                                                resize_nearest)

    ch, cw = ds.crop_size
    times = {"read_jpeg": [], "depth_png": [], "resize_linear": [],
             "resize_nearest": []}
    for cp, dp in zip(ds.color_paths, ds.depth_paths):
        t0 = time.perf_counter()
        color = read_jpeg(cp)
        t1 = time.perf_counter()
        depth = read_png(dp).astype(np.float32)
        t2 = time.perf_counter()
        resize_linear(color.astype(np.float32) / 255.0, (cw, ch))
        t3 = time.perf_counter()
        resize_nearest(depth, (cw, ch))
        t4 = time.perf_counter()
        for k, v in zip(times, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            times[k].append(v)
    return {k: float(np.median(v)) * 1e3 for k, v in times.items()}


def azure_kernel_check(overlay, device):
    """The kernel against its plain version at the Azure session's
    tracking queries, with per-query radii, over that path's final map:
    with sample_near_pcl the tracker keeps no pool, so an iteration
    queries its `pixels` rays (inside the ignored edges of the last frame,
    at its estimated pose) x N_surface samples."""
    import numpy as np
    import torch

    from loopy_slam_torch import run as cli
    from loopy_slam_torch.config import load_config
    from loopy_slam_torch.slam import update_cam
    from loopy_slam_torch.utils.datasets import get_dataset
    from loopy_slam_torch.utils.io import load_checkpoint

    print("== phase 12b': knn_select at the Azure tracking queries, "
          "per-query radii", flush=True)
    cfg = load_config(overlay)
    ck = load_checkpoint(cli.latest_checkpoint(cfg["data"]["output"]))
    grid = checkpoint_grid(cfg, ck, device)
    ds = get_dataset(cfg)
    cam, t = update_cam(cfg), cfg["tracking"]
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    jj, ii = np.mgrid[t["ignore_edge_H"]:cam["H"] - t["ignore_edge_H"],
                      t["ignore_edge_W"]:cam["W"] - t["ignore_edge_W"]]
    flat = torch.as_tensor((jj * cam["W"] + ii).ravel(), device=device)
    q, r = radius_pool_queries(
        [frame_view(cfg, ck, ds, device, len(ds) - 1)], t["pixels"], cam,
        cfg["rendering"], gen, pools=[flat])
    M, T = grid.cell_data.shape[1], grid.cell_data.shape[0] - 1
    return check_shape(f"azure_track_rays Q={q.shape[0]} M={M} T={T}",
                       grid, q, cfg["pointcloud"]["nn_num"], r)


def cofusion_phase():
    """12c: a CoFusion-layout sequence (PNG color, ZIP EXR depth through
    the port's write_exr) loaded through get_dataset; its depth must be
    the written depth over png_depth_scale, bit for bit."""
    import copy as _copy
    import shutil

    import numpy as np

    from loopy_slam_torch.config import DEFAULTS
    from loopy_slam_torch.tools.make_sensor_fixtures import (
        COFUSION_CAM, make_dataset, write_cofusion)
    from loopy_slam_torch.utils.datasets import get_dataset
    from loopy_slam_torch.utils.exr import read_exr

    print(f"== phase 12c: the CoFusion layout, {COFUSION_FRAMES} frames "
          "of EXR depth", flush=True)
    out = os.path.join(HERE, "output", "chip_smoke_cofusion")
    shutil.rmtree(out, ignore_errors=True)
    speed = AZURE_SPEED
    t0 = time.perf_counter()
    write_cofusion(out, COFUSION_FRAMES, speed)
    fixture_s = time.perf_counter() - t0
    cfg = _copy.deepcopy(DEFAULTS)
    cfg.update(dataset="cofusion")
    cfg["cam"] = dict(COFUSION_CAM)
    cfg["data"] = {**cfg["data"], "input_folder": out}
    ds = get_dataset(cfg)
    render = make_dataset(COFUSION_CAM, COFUSION_FRAMES, speed)
    scale = np.float32(COFUSION_CAM["png_depth_scale"])
    equal, exr_s = [], []
    for i in range(len(ds)):
        _, color, depth, pose = ds[i]
        _, want = render.render_frame(render.poses[i])
        want = (want.astype(np.float32) * scale) / scale
        equal.append(bool(np.array_equal(depth, want))
                     and color.shape == (COFUSION_CAM["H"],
                                         COFUSION_CAM["W"], 3)
                     and bool(np.array_equal(pose, np.eye(4))))
        t0 = time.perf_counter()
        read_exr(ds.depth_paths[i])
        exr_s.append(time.perf_counter() - t0)
    summary = {"frames": len(ds), "frames_equal": equal,
               "read_exr_ms_per_frame": float(np.median(exr_s)) * 1e3,
               "fixture_write_s": fixture_s}
    print("cofusion:", json.dumps(summary), flush=True)
    if len(ds) != COFUSION_FRAMES or not all(equal):
        raise AssertionError(f"phase 12c: frames loaded {len(ds)}, equal "
                             f"to the written depth {equal}")
    return summary


def tools_phase(run_dir):
    """12d: get_mesh_video (a turntable, then along the trajectory) and
    viz_html on a run directory. Gates: PNG frames with non-constant
    pixels; an HTML whose payload parses and holds the run's point and
    pose counts."""
    import re

    import numpy as np

    from loopy_slam_torch import run as cli
    from loopy_slam_torch.tools import get_mesh_video, viz_html
    from loopy_slam_torch.utils.imageio import read_png
    from loopy_slam_torch.utils.io import load_checkpoint

    print(f"== phase 12d: get_mesh_video and viz_html on {run_dir}",
          flush=True)
    failures, frame_s = [], {}
    for mode, argv in (("orbit", ["--orbit"]),
                       ("trajectory", ["--every", str(MESH_VIDEO_EVERY)])):
        t0 = time.perf_counter()
        paths, _ = get_mesh_video.main(["--output", run_dir, *argv])
        frame_s[mode] = (time.perf_counter() - t0) / max(len(paths), 1)
        flat = [p for p in paths if np.ptp(read_png(p)) == 0]
        if not paths or flat:
            failures.append(f"{mode}: {len(paths)} frames, constant: "
                            f"{flat}")
    t0 = time.perf_counter()
    html_path = viz_html.main(["--output", run_dir])
    html_s = time.perf_counter() - t0
    with open(html_path) as f:
        m = re.search(r"const D = (\{.*?\});\n", f.read(), re.S)
    payload = json.loads(m.group(1)) if m else {}
    ck = load_checkpoint(cli.latest_checkpoint(run_dir))
    npy = os.path.join(run_dir, "final_point_cloud.npy")
    n_pts = len(np.load(npy)) if os.path.exists(npy) else len(
        ck.get("map", {}).get("pos", ()))
    want = {"n_pts": min(n_pts, 200000), "n_frames": int(ck["idx"]) + 1}
    got = {k: payload.get(k) for k in want}
    if got != want:
        failures.append(f"viz_html payload {got}, the run's {want}")
    summary = {"run_dir": os.path.relpath(run_dir, HERE),
               "mesh_video_s_per_frame": frame_s, "viz_html_s": html_s,
               "viz_html_payload": got,
               "html_bytes": os.path.getsize(html_path)}
    print("tools:", json.dumps(summary), flush=True)
    if failures:
        raise AssertionError("phase 12d: " + "; ".join(failures))
    return summary


def inputs_tools_phase(device, run_dir):
    """Phase 12 in order: 12a and its pool's check, 12b and its check,
    12c, 12d on run_dir. Returns (pretrain summary, azure summary, the two
    shape results, the whole phase's seconds)."""
    import torch

    t0 = time.perf_counter()
    pre, geo_path = pretrain_phase(device)
    shapes = [pretrain_kernel_check(device)]
    torch.cuda.empty_cache()
    azure, azure_cfg = azure_phase(geo_path)
    shapes.append(azure_kernel_check(azure_cfg, device))
    torch.cuda.empty_cache()
    cofusion_phase()
    tools_phase(run_dir)
    phase_s = time.perf_counter() - t0
    print(f"phase 12: {phase_s:.1f} s", flush=True)
    return pre, azure, shapes, phase_s


class IndexProbe:
    """--debug-index: every integer index a CUDA indexing op receives
    (advanced indexing, index_select, gather, index_add_, index_copy_,
    scatter_, scatter_reduce_) is checked against its dimension on the
    device, without a host sync: each call site keeps a running
    (min, max, calls out of range) in device memory. The index is then
    clamped into range, so an out-of-range one does not kill the context
    with a device-side assert and can be reported; results in this mode
    are for finding the op, not for gates. The records are read once,
    after the first mapped frame (`report`), and the probe then comes off.
    Changes nothing in the package: the ops are wrapped in this process
    only."""

    OPS = (("Tensor", "__getitem__"), ("Tensor", "__setitem__"),
           ("Tensor", "index_select"), ("torch", "index_select"),
           ("Tensor", "gather"), ("torch", "gather"),
           ("Tensor", "index_add_"), ("Tensor", "index_copy_"),
           ("Tensor", "scatter_"), ("Tensor", "scatter_reduce_"))

    def __init__(self):
        self.sites = {}  # (where, op, dim size) -> device int64 (3,)
        self.saved = []

    @staticmethod
    def _where():
        f = sys._getframe(2)
        while f is not None and "loopy_slam_torch" not in f.f_code.co_filename:
            f = f.f_back
        if f is None:
            return "?"
        return (f"{os.path.relpath(f.f_code.co_filename, HERE)}:"
                f"{f.f_lineno}")

    def _check(self, op, idx, size):
        import torch

        if not (isinstance(idx, torch.Tensor) and idx.is_cuda
                and idx.numel() and not idx.dtype.is_floating_point
                and idx.dtype != torch.bool):
            return idx
        key = (self._where(), op, int(size))
        lo, hi = torch.aminmax(idx.long())
        bad = ((idx < -size) | (idx >= size)).any().long()
        rec = self.sites.get(key)
        new = torch.stack([lo, hi, bad])
        if rec is None:
            self.sites[key] = new
        else:
            rec[0] = torch.minimum(rec[0], lo)
            rec[1] = torch.maximum(rec[1], hi)
            rec[2] += bad
        return idx.clamp(-size, size - 1)

    def _index_tuple(self, op, t, index):
        import torch

        items = index if isinstance(index, tuple) else (index,)
        out, dim = [], 0
        for it in items:
            if it is None:
                out.append(it)
                continue
            if it is Ellipsis:  # dims after it are not tracked
                return index
            if isinstance(it, torch.Tensor) and it.dtype == torch.bool:
                out.append(it)
                dim += it.dim()
                continue
            if dim < t.dim():
                it = self._check(op, it, t.shape[dim])
            out.append(it)
            dim += 1
        return tuple(out) if isinstance(index, tuple) else out[0]

    def install(self):
        import torch

        probe = self
        T = torch.Tensor
        owners = {"Tensor": T, "torch": torch}
        orig = {(owner, name): getattr(owners[owner], name)
                for owner, name in self.OPS}
        self.saved = [(owners[owner], name, orig[(owner, name)])
                      for owner, name in self.OPS]

        def getitem(t, index):
            if t.is_cuda:
                index = probe._index_tuple("getitem", t, index)
            return orig[("Tensor", "__getitem__")](t, index)

        def setitem(t, index, value):
            if t.is_cuda:
                index = probe._index_tuple("setitem", t, index)
            return orig[("Tensor", "__setitem__")](t, index, value)

        def dim_op(fn, name):
            def wrapped(t, dim, index, *a, **kw):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    d = dim % max(t.dim(), 1)
                    index = probe._check(name, index, t.shape[d])
                return fn(t, dim, index, *a, **kw)
            return wrapped

        T.__getitem__ = getitem
        T.__setitem__ = setitem
        for owner, name in self.OPS[2:]:
            setattr(owners[owner], name, dim_op(orig[(owner, name)], name))

    def uninstall(self):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)
        self.saved = []

    def report(self, what):
        import torch

        self.uninstall()
        torch.cuda.synchronize()
        keys = list(self.sites)
        vals = (torch.stack([self.sites[k] for k in keys]).tolist()
                if keys else [])
        bad = [{"site": k[0], "op": k[1], "size": k[2], "min": v[0],
                "max": v[1], "calls_out_of_range": v[2]}
               for k, v in zip(keys, vals) if v[2]]
        print(f"index probe ({what}): {len(keys)} call sites, "
              f"{len(bad)} out of range: {json.dumps(bad)}", flush=True)
        return bad


def install_index_probe():
    """Put an IndexProbe on every op until the first mapped frame ends,
    then print its report (the `--debug-index` mode)."""
    from loopy_slam_torch.slam import LoopySLAM

    probe = IndexProbe()
    probe.install()
    map_frame = LoopySLAM.map_frame

    def first_map_frame(self, idx, *a, **kw):
        try:
            return map_frame(self, idx, *a, **kw)
        finally:
            if probe.saved:
                probe.report(f"through map_frame({idx})")
            LoopySLAM.map_frame = map_frame
    LoopySLAM.map_frame = first_map_frame
    return probe


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


# phase 13's sessions: phase 4's configuration on two ranks, widths and
# depth as phase 4 runs them (1500 x 40 tracking, 5000 mapping pixels over
# a window of 12, 800 / 300 mapping iterations, capacity 262,144); with
# the mapping iterations halved the ray-DP session ended 4.90 mm off on an
# H100 80GB HBM3 at 700 W, over the 3 mm gate, so the script's time came
# from the TUM path's color refinement instead
MULTI_OVERRIDES = {
    "mapping": {"segment_strategy": "none", "color_refine": False,
                "vis_freq": 0},
    "tracking": {"vis_freq": 0},
    "rendering": {"eval_img": False},
    "meshing": {"eval_rec": False},
}


def nccl_rank(mesh):
    """One rank of a one-rank NCCL group: an all_reduce on the card."""
    import torch
    import torch.distributed as dist

    t = torch.arange(4, dtype=torch.float32, device=mesh.device)
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return {"backend": mesh.backend, "sum": t.cpu().tolist()}


def mailbox_rank(mesh):
    """One rank of 13a's mailbox check: psum and ring_shift through the
    CUDA IPC mailboxes against the same collectives through gloo on host
    copies, on inputs seeded by rank. Returns each case's bit-equality,
    largest difference and both routes' ms."""
    import torch
    import torch.distributed as dist

    from loopy_slam_torch.parallel.mesh import MAILBOX_BYTES

    if mesh._boxes is None:
        raise AssertionError(f"rank {mesh.rank}: no mailboxes on a shared "
                             f"card (backend {mesh.backend})")
    g = torch.Generator().manual_seed(1300 + mesh.rank)
    n_big = MAILBOX_BYTES // 4 + (3 << 20) + 17  # two pieces
    fetch = torch.randn(12480, 8, 67, generator=g)  # a ring fetch hop
    idx = torch.randint(-2 ** 31, 2 ** 31 - 1, (12480, 8), generator=g,
                        dtype=torch.int32)
    grad = torch.randn(1 << 16, 64, generator=g)  # ray-DP's feature grad
    big = torch.randn(n_big, generator=g)
    cases = [("psum", [grad, torch.randn(1000, generator=g)], 0),
             ("psum", [big], 0), ("ring", [fetch, idx], 1),
             ("ring", [fetch, idx], -1), ("ring", [big], 1)]
    w = mesh.world
    out = []
    for kind, host, shift in cases:
        dev = [t.to(mesh.device) for t in host]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = (mesh.psum(dev) if kind == "psum"
               else mesh.ring_shift(dev, shift))
        torch.cuda.synchronize()
        box_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ref = []
        for t in host:
            c = t.clone()
            if kind == "psum":
                dist.all_reduce(c, op=dist.ReduceOp.SUM)
            else:
                split_in, split_out = [0] * w, [0] * w
                split_in[(mesh.rank + shift) % w] = c.shape[0]
                split_out[(mesh.rank - shift) % w] = c.shape[0]
                r = torch.empty_like(c)
                dist.all_to_all_single(r, c, output_split_sizes=split_out,
                                       input_split_sizes=split_in)
                c = r
            ref.append(c)
        gloo_ms = (time.perf_counter() - t0) * 1e3
        equal = all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))
        err = max(float((a.cpu().double() - b.double()).abs().max())
                  for a, b in zip(got, ref))
        out.append({"kind": kind, "shift": shift,
                    "mb": sum(t.numel() * 4 for t in host) / 1e6,
                    "bit_equal": equal, "max_abs_err": err,
                    "mailbox_ms": box_ms, "gloo_host_ms": gloo_ms})
    return out


def multi_phase_dryrun():
    """13a: the mailboxes against gloo on two ranks, the port's dry run on
    two ranks, and NCCL's code path on one."""
    from loopy_slam_torch.parallel import mesh
    from loopy_slam_torch.parallel.dryrun import dryrun

    print("== phase 13a: the mailboxes against gloo, the multi-device dry "
          "run (2 ranks) and a 1-rank NCCL all_reduce", flush=True)
    store = os.path.join(HERE, "output", "chip_smoke_multi")
    t0 = time.perf_counter()
    boxes = mesh.launch(mailbox_rank, 2, timeout_s=300.0, store_dir=store)
    print("mailbox:", json.dumps(boxes), flush=True)
    bad = [(r, c) for r, res in enumerate(boxes) for c in res
           if not c["bit_equal"]]
    if bad:
        raise AssertionError(f"the mailboxes disagree with gloo: {bad}")
    rec = dryrun(2, store_dir=store)
    nccl = mesh.launch(nccl_rank, 1, timeout_s=120.0, store_dir=store)[0]
    if nccl["backend"] != "nccl" or nccl["sum"] != [0.0, 1.0, 2.0, 3.0]:
        raise AssertionError(f"the NCCL all_reduce returned {nccl}")
    print("dryrun:", json.dumps({**rec, "nccl": nccl,
                                 "phase_s": time.perf_counter() - t0}),
          flush=True)
    return rec


def multi_session(map_shard: bool, slice_summary):
    """13b / 13c: phase 4's room session on two ranks; returns its summary
    (with the per-rank launch counts summed under knn_select_launches)."""
    import numpy as np

    from loopy_slam_torch import run as cli
    from loopy_slam_torch.parallel import mesh

    name = "map_shard" if map_shard else "ray_dp"
    print(f"== phase 13{'b' if map_shard else 'c'}: {name} session, "
          "synthetic room, 6 frames, 2 ranks", flush=True)
    out = os.path.join(HERE, "output", f"chip_smoke_{name}")
    cfg = room_config(6, out, MULTI_OVERRIDES)
    cfg["parallel"] = {"n_devices": 2, "map_shard": map_shard}
    t0 = time.perf_counter()
    res = mesh.launch(cli.session, 2, cfg, None, None, timeout_s=600.0,
                      store_dir=os.path.join(HERE, "output",
                                             "chip_smoke_multi"))
    wall = time.perf_counter() - t0
    ranks = [r.pop("rank") for r in res]
    st = res[0]
    coll = {}
    for r in ranks:
        for k, v in r["collectives"].items():
            c = coll.setdefault(k, {"s": 0.0, "calls": 0, "bytes": 0})
            for f in c:
                c[f] += v[f]
    iters = ranks[0]["collectives"].get("psum", {}).get("calls", 0)
    coll_s = sum(v["s"] for v in ranks[0]["collectives"].values())
    med = {k: float(np.median(v)) for k, v in st["timings_s"].items() if v}
    summary = {
        "path": name, "frames": 6, "ranks": 2,
        "backend": ranks[0]["backend"], "ate_rmse_m": st["rmse"],
        "health_rejects": st["health_rejects"], "n_points": st["n_points"],
        "shard_counts": [r["shard_count"] for r in ranks],
        "launches_by_rank": [r["knn_select_launches"] for r in ranks],
        "knn_select_launches": sum(r["knn_select_launches"] for r in ranks),
        "checksums_equal": len({r["checksum"] for r in ranks}) == 1,
        "run_s_by_rank": [r["run_s"] for r in ranks], "wall_s": wall,
        "track_median_s": med.get("track"), "map_median_s": med.get("map"),
        "track_times_s": st["timings_s"].get("track"),
        "map_times_s": st["timings_s"].get("map"),
        "phase4_track_median_s": slice_summary and slice_summary.get(
            "track_median_s"),
        "phase4_map_median_s": slice_summary and slice_summary.get(
            "map_median_s"),
        "collectives_rank0": ranks[0]["collectives"],
        "collectives_all_ranks": coll,
        "optimizer_iters_rank0": iters,
        "collective_ms_per_iter": (coll_s / iters * 1e3) if iters else None,
        "card": nvidia_smi_line(),
    }
    print("multi:", json.dumps(summary), flush=True)
    what = f"the {name} session"
    if not np.isfinite(st["rmse"]) or st["rmse"] > ATE_GATE_M:
        raise AssertionError(f"{what}: ATE {st['rmse']:.5f} m > "
                             f"{ATE_GATE_M} m")
    if st["health_rejects"]:
        raise AssertionError(f"{what}: {st['health_rejects']} rejects")
    if min(summary["launches_by_rank"]) <= 0:
        raise AssertionError(f"{what}: a rank never launched knn_select "
                             f"({summary['launches_by_rank']})")
    if not summary["checksums_equal"]:
        raise AssertionError(f"{what}: the ranks' replicated state differs")
    if map_shard and (min(summary["shard_counts"]) <= 0 or sum(
            summary["shard_counts"]) != st["n_points"]):
        raise AssertionError(f"{what}: shard counts "
                             f"{summary['shard_counts']} vs the gathered "
                             f"{st['n_points']}")
    return summary, cfg


def shard_kernel_check(cfg, dp_cfg, device):
    """13d: the kernel at the shapes phase 13 launches. On one shard's
    local grid (shard 0's points of the map-shard run's final checkpoint,
    indexed as the shard indexes them: knn.build at the configured table
    size and row depth): rank 0's batch of one mapping iteration (pixels /
    window / 2 rays of each of a 12-frame window: the run's mapped frames,
    repeated as the mapper pads; N_surface samples each) and of one
    tracking iteration (tracking pixels / 2 rays of the last frame). On
    the ray-DP run's whole map (indexed as restore indexes it): a rank's
    mapping pool (pixel_pool_factor x pixels / window / 2 rays of each
    window frame). Scalar radius."""
    import numpy as np
    import torch

    from loopy_slam_torch import run as cli
    from loopy_slam_torch.mapping.point_cloud import MapOptions
    from loopy_slam_torch.ops import knn
    from loopy_slam_torch.parallel.map_shard import owner_of_points_np
    from loopy_slam_torch.slam import update_cam
    from loopy_slam_torch.utils.datasets import get_dataset
    from loopy_slam_torch.utils.io import load_checkpoint

    print("== phase 13d: knn_select at a shard's local mapping batch",
          flush=True)
    ck = load_checkpoint(cli.latest_checkpoint(cfg["data"]["output"]))
    mopts = MapOptions.from_cfg(cfg)
    pos_np = np.asarray(ck["map"]["pos"], np.float32)
    mine = pos_np[owner_of_points_np(pos_np, mopts.cell_size, 2) == 0]
    cap = 2048
    while cap < len(mine) + 1024:
        cap *= 2
    pos = torch.zeros((cap, 3), device=device)
    pos[:len(mine)] = torch.as_tensor(mine, device=device)
    grid = knn.build(pos, torch.arange(cap, device=device) < len(mine),
                     mopts.cell_size, mopts.table_size, mopts.max_per_cell)
    ds = get_dataset(cfg)
    m, pc = cfg["mapping"], cfg["pointcloud"]
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    window = m["mapping_window_size"]
    mapped = list(range(len(ds) - 1, -1, -m["every_frame"]))
    frames = [mapped[i % len(mapped)] for i in range(window)]
    per_frame = max(m["pixels"] // window, 1) // 2
    cam = update_cam(cfg)
    views = [frame_view(cfg, ck, ds, device, i) for i in frames]
    k, r = pc["nn_num"], pc["radius_query"]
    M, T = grid.cell_data.shape[1], grid.cell_data.shape[0] - 1
    q, _ = radius_pool_queries(views, per_frame, cam, cfg["rendering"], gen)
    out = [check_shape(f"shard_map_batch Q={q.shape[0]} F={len(frames)} "
                       f"points={len(mine)} M={M} T={T}", grid, q, k, r)]
    q, _ = radius_pool_queries(
        [frame_view(cfg, ck, ds, device, len(ds) - 1)],
        cfg["tracking"]["pixels"] // 2, cam, cfg["rendering"], gen)
    out.append(check_shape(f"shard_track_batch Q={q.shape[0]} points="
                           f"{len(mine)} M={M} T={T}", grid, q, k, r))
    dck = load_checkpoint(cli.latest_checkpoint(dp_cfg["data"]["output"]))
    dgrid = checkpoint_grid(dp_cfg, dck, device)
    q, _ = radius_pool_queries(
        [frame_view(dp_cfg, dck, ds, device, i) for i in frames],
        m.get("pixel_pool_factor", 8) * per_frame, cam, cfg["rendering"],
        gen)
    out.append(check_shape(
        f"ray_dp_rank_pool Q={q.shape[0]} F={len(frames)} "
        f"M={dgrid.cell_data.shape[1]} T={dgrid.cell_data.shape[0] - 1}",
        dgrid, q, k, r))
    return out


def multi_phase(device, slice_summary):
    """Phase 13: returns (map-shard summary, ray-DP summary, 13d's shape
    results)."""
    import torch

    t0 = time.perf_counter()
    multi_phase_dryrun()
    shard, shard_cfg = multi_session(True, slice_summary)
    torch.cuda.empty_cache()
    dp, dp_cfg = multi_session(False, slice_summary)
    shapes = shard_kernel_check(shard_cfg, dp_cfg, device)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s", flush=True)
    return shard, dp, shapes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=6,
                    help="frames of the slice-1 path (phase 4)")
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler trace of a 6-frame session")
    ap.add_argument("--variants", action="store_true",
                    help="also build and time the VARIANTS of knn_select.cu")
    ap.add_argument("--dataset-runs", type=int, default=0,
                    help="run only the Replica and ScanNet paths, this many "
                         "times each (their spread; prints no result)")
    ap.add_argument("--base-runs", type=int, default=0,
                    help="run only the base-config path and its kernel "
                         "check, this many times (prints no result)")
    ap.add_argument("--tools-runs", type=int, default=0,
                    help="run only phase 12 (the last inputs and the "
                         "tools), this many times (prints no result; "
                         "runs phase 6 first for 12d's run directory)")
    ap.add_argument("--multi-runs", type=int, default=0,
                    help="run only phase 13 (the multi-device path), this "
                         "many times (prints no result)")
    ap.add_argument("--debug-index", action="store_true",
                    help="check every CUDA index op's indices on the "
                         "device until the first mapped frame ends, and "
                         "report the out-of-range call sites (debugging; "
                         "clamps them, so gates do not hold)")
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
    t_start = time.perf_counter()
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
    if args.dataset_runs:
        for _ in range(args.dataset_runs):
            replica_phase()
            scannet_phase()
        return 0
    if args.base_runs:
        if args.debug_index:
            install_index_probe()
        for _ in range(args.base_runs):
            _, base_cfg = base_phase(device)
            base_kernel_check(base_cfg, device)
        print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.multi_runs:
        for _ in range(args.multi_runs):
            multi_phase(device, None)
        print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
        return 0
    cli_dir = os.path.join(HERE, "output", "chip_smoke_cli")
    if args.tools_runs:
        if not os.path.exists(os.path.join(cli_dir, "mesh",
                                           "final_mesh.ply")):
            cli_phase()
        for _ in range(args.tools_runs):
            inputs_tools_phase(device, cli_dir)
        print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
        return 0

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
    torch.cuda.empty_cache()
    tum_summary, tum_cfg = tum_phase()
    shape_results += tum_kernel_check(tum_cfg, device)
    torch.cuda.empty_cache()
    replica_summary, replica_cfg = replica_phase()
    shape_results.append(replica_kernel_check(replica_cfg, device))
    torch.cuda.empty_cache()
    scannet_summary, scannet_cfg = scannet_phase()
    shape_results.append(scannet_kernel_check(scannet_cfg, device))
    torch.cuda.empty_cache()
    base_summary, base_cfg = base_phase(device)
    shape_results += base_kernel_check(base_cfg, device)
    torch.cuda.empty_cache()
    pre_summary, azure_summary, shapes, _ = inputs_tools_phase(device,
                                                               cli_dir)
    shape_results += shapes
    torch.cuda.empty_cache()
    shard_summary, dp_summary, shard_shapes = multi_phase(device, summary)
    shape_results += shard_shapes
    if args.profile:
        profile_phase(device)

    main_shape = next(r for r in shape_results
                      if r["shape"].startswith("map_pool"))
    # each path's count, reset just before its run and read just after
    by_path = {name: res["knn_select_launches"] for name, res in (
        ("slice1", summary), ("segmented", seg_summary),
        ("cli", cli_summary), ("tum", tum_summary),
        ("replica", replica_summary), ("scannet", scannet_summary),
        ("base", base_summary), ("pretrain", pre_summary),
        ("azure", azure_summary), ("map_shard", shard_summary),
        ("ray_dp", dp_summary))}
    entry = {
        "name": "knn_select", "route": "cuda",
        "source": "loopy_slam_torch/csrc/knn_select.cu",
        "replaces": "loopy_slam_tpu/ops/knn.py:231",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
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
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        # the failing phase's traceback on stdout as well, after the
        # phase's own lines (a device-side assert prints its line from the
        # device; the CUDA error reaches Python at the next sync)
        traceback.print_exc(file=sys.stdout)
        sys.stdout.flush()
        raise
