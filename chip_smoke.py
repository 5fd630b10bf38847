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
     6 frames (cut from 31, then 16, then 8, then 6, so that the whole
     script with the TUM, Replica and ScanNet paths stays near 1000 s on
     the card), with the kernels' launch counts reset just
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
     count (11, cut from 31), the output and both vis_freq (5): first
     with --stop 5, then with --resume in a fresh session, which runs
     frames 6-10, color refinement and the final evaluation; prints an
     `eval:` line (resume frame, map counts at the checkpoint and after
     restore, visualizer images and time per vis, ATE, rejects, render
     and reconstruction metrics, the evaluation's step times, launches)
     and gates on the
     resume at frame 6 with the checkpoint's count restored, the four
     visualizer PNGs, ATE <= 3 mm, no rejects, a mesh with faces, psnr >
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
     10000 mapping pixels, color refinement, the final evaluation), only
     the input, the output and both vis_freq (6) changed; prints a `tum:`
     line (frames, crop, the r_query map's median/min/max, the gradient
     pool and inserts, the phase times, ATE, rejects, peak memory,
     launches, the host's PNG decoding and undistortion seconds a frame)
     and gates on >= 10 associated frames, ATE < 2 cm, no rejects,
     gradient inserts > 0, a mesh with faces, no evaluation error and
     launches > 0; then (8b) holds the kernel against its plain version,
     with per-query radii, at the tracking pool and a mapping pool over
     that path's final map;
  9. runs the Replica path: the fixture writer puts a 6-frame
     Replica-format sequence of the synthetic room (680x1200 JPEG color
     at quality 92 through the port's own JPEG writer, 16-bit depth,
     traj.txt; 0.004 of the orbit a frame) on disk, and the CLI runs
     configs/Replica/room0.yaml as shipped on it (1500 tracking pixels x
     40 iterations, 5000 mapping pixels over a window of 12, 1500 first
     iterations, color refinement, the final evaluation), only the input,
     the output and both vis_freq (5) changed; prints a `replica:` line
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

Prints a JSON line of per-kernel numbers, then the card's name and power
limit, then {"ok": true, "device": {...}} as the last line. Exits non-zero
(and prints no result) without a CUDA device or if any phase fails.
`--dataset-runs N` runs only phases 9 and 10, N times each with their
gates, for their run-to-run spread (no kernels line, no result line).
Imports nothing of JAX; needs no PyYAML, cv2 or PIL (phases 3-5 build
their config from DEFAULTS, phases 6 and 8-10 read YAML with the port's
own reader, and phases 8-10 write and read their PNGs and JPEGs with the
port's codecs).
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
    """Least time for the k-NN function on these inputs, the larger of two.
    Bytes over HBM bandwidth: the fill count and the filled slots of each
    row the queries touch, read once (empty slots hold the 1e9 sentinel and
    change no output), the queries, their radii (per_query_radius) and
    cell_size read, D/I/neighbor_num written. f32 operations over the f32
    peak: 8 per filled candidate in each query's stencil (3 sub, 3 mul, 2
    add)."""
    import torch

    from loopy_slam_torch.ops import knn

    h = knn.stencil_rows(grid, queries)  # repeated probes -> empty row
    fill = grid.cell_fill.long()
    rows = torch.unique(h)
    Q = queries.shape[0]
    nbytes = (int(fill[rows].sum()) * 16 + rows.numel() * 4
              + Q * (16 if per_query_radius else 12) + 4 + Q * (k * 8 + 4))
    ops = int(fill[h].sum()) * 8
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
                    vis_freq: int) -> str:
    """A config overlay of a shipped dataset YAML that changes only the
    input folder, the output directory and both vis_freq. Returns its
    path."""
    path = os.path.join(out, os.path.basename(base_yaml))
    with open(path, "w") as f:
        f.write(f"inherit_from: {json.dumps(base_yaml)}\n"
                f"data: {{input_folder: {json.dumps(fixture)}, "
                f"output: {json.dumps(out)}}}\n"
                f"tracking: {{vis_freq: {vis_freq}}}\n"
                f"mapping: {{vis_freq: {vis_freq}}}\n")
    return path


def run_dataset_path(overlay, out):
    """`python -m loopy_slam_torch.run` (its `main`) on overlay, with the
    kernel's launch count reset just before and read just after; the
    session's stats plus launches, run seconds, peak device memory, the
    final mesh's face count and the visualizer's PNGs."""
    import torch

    from loopy_slam_torch import run as cli
    from loopy_slam_torch.ops import knn
    from loopy_slam_torch.utils.io import read_ply_mesh

    knn.KNN_SELECT_LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = cli.main([overlay])
    run_s = time.perf_counter() - t0
    launches = knn.KNN_SELECT_LAUNCHES.count
    mesh_path = os.path.join(out, "mesh", "final_mesh.ply")
    n_faces = (len(read_ply_mesh(mesh_path)[1])
               if os.path.exists(mesh_path) else 0)
    vis = sorted(f"{d}/{f}" for d in ("tracking_vis", "mapping_vis")
                 if os.path.isdir(os.path.join(out, d))
                 for f in os.listdir(os.path.join(out, d))
                 if f.endswith(".png"))
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
                          "freiburg1_desk.yaml"), fixture, TUM_VIS_FREQ)
    stats, extra = run_dataset_path(overlay, out)

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
# frames (mapped frames 0 and 5). Gates: the room paths' band is <= 3 mm,
# so < 1 cm still fails a session that loses track (decimeters off)
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
        fixture, REPLICA_VIS_FREQ)
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
    ap.add_argument("--frames", type=int, default=6,
                    help="frames of the slice-1 path (phase 4)")
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler trace of a 6-frame session")
    ap.add_argument("--variants", action="store_true",
                    help="also build and time the VARIANTS of knn_select.cu")
    ap.add_argument("--dataset-runs", type=int, default=0,
                    help="run only the Replica and ScanNet paths, this many "
                         "times each (their spread; prints no result)")
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
    if args.dataset_runs:
        for _ in range(args.dataset_runs):
            replica_phase()
            scannet_phase()
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
    if args.profile:
        profile_phase(device)

    main_shape = next(r for r in shape_results
                      if r["shape"].startswith("map_pool"))
    # each path's count, reset just before its run and read just after
    by_path = {name: res["knn_select_launches"] for name, res in (
        ("slice1", summary), ("segmented", seg_summary),
        ("cli", cli_summary), ("tum", tum_summary),
        ("replica", replica_summary), ("scannet", scannet_summary))}
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
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
