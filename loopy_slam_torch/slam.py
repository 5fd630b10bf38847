"""LoopySLAM orchestrator: tracking, mapping, submaps and loop closure on
one device.

Port of loopy_slam_tpu/slam.py's host loop, with the same schedule:

    map(0); track(1) .. track(k*E); map(k*E); track(k*E+1) ...

Frame 0 and 1 take the ground-truth pose; every later frame is tracked from
the constant-speed motion model (or, with tracking.visual_odometer and
without const_speed_assumption, from direct RGB-D odometry against the
previous frame); every `mapping.every_frame` frames (and the last) inserts
points and optimizes the map over a keyframe window, with mapping.BA also
the window's poses once it holds more than 4 keyframes (the trained poses
go back into the keyframes' and the current frame's estimates).

Submaps: with mapping.segment_strategy 'rot_trans' (the camera left its
segment anchor) or 'fixed', a mapped frame opens a new segment: the active
map is archived to the host and its points that the new anchor sees carry
over. At each boundary the closed segment gets a TSDF registration cloud
and an ORB baseline score; from four segments on, loop closure proposes
edges by place recognition, registers them, solves the pose graph and
moves segments, trajectory and the device map rigidly. With
mapping.color_refine, the last frame is mapped again over the merged
global map of all segments, with the segment anchors as the window.

With model.encode_exposure (ScanNet), each frame has an exposure latent:
the tracker optimizes it with the exposure MLP beside the pose and hands
both to the session; keyframes keep theirs; the mapper applies each
window frame's own affine and trains the current frame's latent; each
mapped frame's latent and a snapshot of the color decoder
(ckpts/color_decoder/<idx>.pkl) are kept so that final_eval renders the
frame as it was mapped. Ground-truth poses that are not finite (ScanNet
marks frames without one so) are skipped wherever the session reads them.

With use_dynamic_radius, each frame's color gradient (on the host) sets
per-pixel add and query radii: insertion gates, tracking, mapping (each
keyframe keeps its query-radius map) and renders use them. With
tracking.sample_with_color_grad the tracker draws its pixels from the top
color-gradient pixels, and mapping.pixels_based_on_color_grad adds points
at such pixels each mapped frame.

After the run: `render_img` renders full frames through the map,
`final_eval` scores renders and a fused mesh, and `restore` continues a
run from a checkpoint written by `finalize` (by either package). With
tracking.vis_freq / mapping.vis_freq, residual panels are written during
the run (utils/visualizer.py).

With wandb set, the tracking and mapping losses go to wandb when it is
installed (utils/telemetry.py; a no-op otherwise).

Multi-device (parallel.*, one process per rank over torch.distributed,
started by parallel/mesh.launch; `mesh` is this rank's handle). With
parallel.n_devices = n > 1 every rank runs this host loop:
  * ray data parallelism (map_shard off, parallel/sharded.py): the map,
    decoders and Adam state are replicated; rank 0 tracks and broadcasts
    the pose (and its draw stream's state, so the replicated stream stays
    in step); every rank inserts the same points and maps with its own
    pixels / n rays a frame, gradients summed every iteration;
  * map sharding (map_shard on, parallel/map_shard.py): each rank holds
    the cells it owns; tracking, insertion, growth (by the largest shard,
    a pmax), the frustum mask, mapping and the PGO move run on the shards
    with ring k-NN; self.map_state is a gathered snapshot of every shard
    (with the replicated input cloud) for rendering, checkpoints, segment
    close and the global merge, refreshed on demand; carry-over, the
    merged map and a restore scatter host points to their owners.
Each rank has two draw streams: the replicated one (`draw`, setup_seed)
for every replicated decision, and its own (`rank_draw`) for the pixels
it samples. Host-only work runs on rank 0 and what the session needs of
it is broadcast: the loop-closure correction (TSDF cloud, registration,
pose graph), the visual odometer's motion model and the ray-DP tracked
pose; rank 0 alone writes outputs (checkpoints, visualizer, wandb) and
the caller evaluates on rank 0. There is no silent single-device path:
n_devices > 1 without a mesh of that size raises. Map sharding with
n_devices <= 1 is one shard, which is the plain path (as in the JAX
package on one device).

A config that asks for a feature outside the port raises
NotImplementedError naming its ROADMAP.md item instead of silently running
something else.
"""

from __future__ import annotations

import copy
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import resolve_device
from .convert import (decoders_from_numpy, decoders_to_numpy,
                      exposure_state_from_numpy)
from .mapping import mapper as mapper_mod
from .mapping import tracker as tracker_mod
from .mapping.fragments import FragmentManager
from .mapping.loop_closure import LoopCloser, LoopClosureConfig
from .mapping.point_cloud import (MapOptions, MapState, init_map,
                                  input_cloud_insert, valid_mask)
from .models import track_render
from .models.decoder import init_decoders, trainable_mask
from .models.renderer import RenderOptions, render_batch_ray
from .ops import knn, tsdf
from .parallel import map_shard as msh
from .parallel.sharded import sharded_optimize_map
from .ops.orb import extract_orb
from .ops.camera import get_rays, np_c2w_from_tensor, tensor_from_c2w
from .ops.image import dynamic_radius_maps, select_pixels_by_grad
from .ops.draws import TorchDraws
from .ops.odometry import rgbd_odometry
from .tools.cull_mesh import cull_mesh
from .tools.eval_images import evaluate_renders
from .tools.eval_recon import calc_2d_metric, calc_3d_metric
from .tools.get_mesh_tsdf_fusion import mesh_from_renders
from .utils.datasets import get_dataset
from .utils.cost import CostCounter
from .utils.io import (load_checkpoint, save_checkpoint, write_ply_mesh,
                       write_ply_points)
from .utils import telemetry
from .utils.telemetry import WandbLogger
from .utils.visualizer import Visualizer


def update_cam(cfg) -> Dict[str, float]:
    """Rescale/crop intrinsics (crop_size resize, crop_edge cropping)."""
    cam = dict(cfg["cam"])
    if cam.get("crop_size") is not None:
        ch, cw = cam["crop_size"]
        sx = cw / cam["W"]
        sy = ch / cam["H"]
        cam["fx"] *= sx
        cam["fy"] *= sy
        cam["cx"] *= sx
        cam["cy"] *= sy
        cam["W"], cam["H"] = cw, ch
    e = cam.get("crop_edge") or 0
    if e > 0:
        cam["H"] -= 2 * e
        cam["W"] -= 2 * e
        cam["cx"] -= e
        cam["cy"] -= e
    return cam


def check_slice(cfg) -> None:
    """Raise for a configuration the port cannot run. Every option of the
    JAX package is in (multi-device, ROADMAP.md item 13, the last); map
    sharding needs a power-of-two rank count."""
    seg = cfg["mapping"]["segment_strategy"]
    if seg not in ("rot_trans", "fixed", "none"):
        raise ValueError(f"mapping.segment_strategy={seg!r} is not one of "
                         "'rot_trans', 'fixed' or 'none'")
    par = cfg.get("parallel", {})
    n = int(par.get("n_devices", 0) or 0)
    if par.get("map_shard", False) and n > 1 and n & (n - 1):
        raise ValueError(f"parallel.map_shard needs a power-of-two "
                         f"n_devices, got {n}")


def parallel_ranks(cfg) -> int:
    """How many ranks a config runs on: parallel.n_devices when above 1,
    else 1 (map sharding on one device is one shard: the plain path)."""
    return max(int(cfg.get("parallel", {}).get("n_devices", 0) or 0), 1)


def _upload_frame(color_np, depth_np, device):
    """Host->device frame transfer through the reference's quantization:
    color as uint8 (<= 1/510 rounding) and depth as uint16 with a per-frame
    scale, dequantized to float32 on the device."""
    c8 = np.clip(np.rint(color_np * 255.0), 0, 255).astype(np.uint8)
    dmax = float(depth_np.max())
    scale = max(dmax, 1e-6) / 65535.0
    d16 = np.rint(depth_np * (1.0 / scale)).astype(np.uint16)
    color = torch.from_numpy(c8).to(device).float() * np.float32(1.0 / 255.0)
    depth = torch.from_numpy(d16.astype(np.int32)).to(device).float() \
        * np.float32(scale)
    return color, depth


class LoopySLAM:
    def __init__(self, cfg: Dict, output: Optional[str] = None,
                 device=None, init_params=None, mesh=None):
        """cfg: a loaded config. device: None for the CUDA card (raises
        without one), or e.g. "cpu". init_params: optional decoder pytree
        of numpy arrays (JAX layout) to start from instead of a random
        init; the pretrained geometry trunk still loads over it. mesh: this
        rank's parallel/mesh.Mesh when parallel.n_devices > 1 (its device
        is the session's)."""
        n_ranks = parallel_ranks(cfg)
        if n_ranks > 1 and (mesh is None or mesh.size() != n_ranks):
            raise RuntimeError(
                f"parallel.n_devices = {n_ranks} runs one process per rank: "
                "start the session on every rank through "
                "loopy_slam_torch.parallel.mesh.launch with a mesh of that "
                "size (python -m loopy_slam_torch.run does)")
        if n_ranks == 1 and mesh is not None and mesh.size() > 1:
            raise ValueError(f"a mesh of {mesh.size()} ranks needs "
                             f"parallel.n_devices = {mesh.size()}")
        self.mesh = mesh if n_ranks > 1 else None
        self.rank = self.mesh.rank if self.mesh is not None else 0
        self.map_sharded = n_ranks > 1 and bool(
            cfg.get("parallel", {}).get("map_shard", False))
        self.ray_dp = n_ranks > 1 and not self.map_sharded
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        self.cfg = cfg
        self.verbose = cfg["verbose"] and self.rank == 0
        self.output = output or cfg["data"]["output"]

        cam = update_cam(cfg)
        self.H, self.W = cam["H"], cam["W"]
        self.fx, self.fy = cam["fx"], cam["fy"]
        self.cx, self.cy = cam["cx"], cam["cy"]

        self.dataset = get_dataset(cfg)
        self.n_img = len(self.dataset)
        check_slice(cfg)

        if self.rank == 0:  # rank 0 writes every output
            os.makedirs(os.path.join(self.output, "ckpts"), exist_ok=True)
            self._take_run_lock()

        self.topts = tracker_mod.TrackOptions.from_cfg(cfg)._replace(
            H=self.H, W=self.W, fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy)
        self.mopts_map = MapOptions.from_cfg(cfg)
        self.mopts = mapper_mod.MapperOptions.from_cfg(cfg)._replace(
            H=self.H, W=self.W, fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy)
        self.ropts_tracker = RenderOptions.from_cfg(
            cfg, sigmoid_coef=cfg["rendering"]["sigmoid_coef_tracker"])
        self.ropts_mapper = RenderOptions.from_cfg(
            cfg, sigmoid_coef=cfg["rendering"]["sigmoid_coef_mapper"])

        seed = cfg["setup_seed"]
        self.draw = TorchDraws(seed, self.device)
        # this rank's own stream, for the pixels it samples on a mesh
        self.rank_draw = (self.draw if self.mesh is None else TorchDraws(
            seed * 1000003 + self.rank + 1, self.device))
        self.nprng = np.random.default_rng(seed)

        bf16 = cfg["model"].get("bf16_trunks", True)
        if init_params is None:
            self.dec = init_decoders(self.draw.gen, cfg, self.device)
        else:
            self.dec = decoders_from_numpy(init_params, self.device, bf16)
        self._load_pretrained_geo()
        self.dec_mask = trainable_mask(self.dec, cfg)

        # exposure compensation: the current latent (device), each
        # keyframe's and each mapped frame's (numpy, by frame index)
        self.encode_exposure = cfg["model"]["encode_exposure"]
        self.exposure_feat = torch.zeros(cfg["model"]["exposure_dim"],
                                         device=self.device)
        self.kf_exposure: Dict[int, np.ndarray] = {}
        self.mapped_exposure: Dict[int, np.ndarray] = {}

        self.initial_capacity = int(cfg["pointcloud"].get(
            "initial_capacity", 2 ** 15))
        self.map_state: MapState = init_map(
            self.mopts_map, capacity=min(self.initial_capacity,
                                         self.mopts_map.capacity),
            device=self.device)
        self._count_host = 0  # host shadow of map_state.count
        # map sharding: this rank's shard; map_state is then a snapshot of
        # every shard, stale while _smap_dirty
        self._smap = None
        self._smap_dirty = False
        if self.map_sharded:
            cap_l = max(min(self.initial_capacity, self.mopts_map.capacity)
                        // self.mesh.size(), 2048)
            self._smap = msh.init_sharded_map(cap_l, self.mopts_map,
                                              self.device)
            if self.verbose:
                print(f"map cell-sharded over {self.mesh.size()} ranks "
                      f"({cap_l} rows a shard)")
        elif self.ray_dp and self.verbose:
            print(f"mapping data-parallel over {self.mesh.size()} ranks")

        self.estimate_c2w = np.zeros((self.n_img, 4, 4), np.float32)
        self.gt_c2w = np.zeros((self.n_img, 4, 4), np.float32)

        m = cfg["mapping"]
        self.every_frame = m["every_frame"]
        self.keyframe_every = m["keyframe_every"]
        self.keyframe_global_every = m["keyframe_global_every"]
        self.mapping_window_size = m["mapping_window_size"] * (
            2 if self.n_img > 4000 else 1)
        # the current frame's (H, W) add and query radius maps on the
        # device, with use_dynamic_radius (else None)
        self.use_dynamic_radius = cfg["use_dynamic_radius"]
        self.cur_r_add = self.cur_r_query = None

        # keyframe pixels (and query-radius maps) on the device, poses on
        # the host
        kf_cap = self.n_img // min(self.keyframe_every,
                                   self.keyframe_global_every) + 4
        self.kf_color = torch.zeros((kf_cap, self.H, self.W, 3),
                                    device=self.device)
        self.kf_depth = torch.zeros((kf_cap, self.H, self.W),
                                    device=self.device)
        self.kf_rq = (torch.zeros((kf_cap, self.H, self.W),
                                  device=self.device)
                      if self.use_dynamic_radius else None)
        self.kf_slots_used = 0
        self.kf_slot_of_idx: Dict[int, int] = {}
        self.keyframe_list: List[int] = []
        self.keyframe_global_list: List[int] = []
        self.kf_est_c2w: Dict[int, np.ndarray] = {}
        self.kf_gt_c2w: Dict[int, np.ndarray] = {}
        self.selected_keyframes: Dict[int, List] = {}
        self.prev_mapped_idx = None
        # [loss EMA, total rejects, consecutive-reject streak], on device
        self.track_health = torch.zeros(3, device=self.device)
        self._last_rejects = 0.0
        self.timings: Dict[str, List[float]] = {"track": [], "map": []}
        # the session's tracer (spans); its detail level is off until enable()
        self.tracer = telemetry.Timers()
        # the last tracked frame's and the last full steady-state mapping
        # chunk's calls, for roofline()
        self._roofline_calls: Dict[str, Dict] = {}
        # per tracked frame, the color-gradient pool's size before its
        # resample; per mapped frame, the locations the gradient picks added
        self.grad_stats: Dict[str, List[int]] = {"track_pool": [],
                                                 "map_locations": []}
        # the visual odometer's previous frame (color, depth) as uploaded,
        # on the device; the mapped frames that ran bundle adjustment
        self._prev_frame = None
        self.ba_frames: List[int] = []
        self.wandb = WandbLogger(cfg if self.rank == 0
                                 else {**cfg, "wandb": False},
                                 name=os.path.basename(self.output))

        # submaps + loop closure
        self.fm = FragmentManager(
            m["segment_rel_trans"], m["segment_rot_cos"],
            self.H, self.W, self.fx, self.fy, self.cx, self.cy)
        self.lc = LoopCloser(LoopClosureConfig.from_cfg(cfg), self.fm,
                             device=self.device)
        self.active_sensor_start = 0
        self.registration_voxel = cfg["meshing"].get(
            "registration_voxel", 5.0 / 512.0)
        self.lc_enabled = m["segment_strategy"] in ("rot_trans", "fixed")
        # host cache of the active segment's frames (color uint8, depth),
        # filled by the run loop; the boundary's TSDF cloud and ORB
        # baseline read it instead of reloading frames from the dataset
        self._seg_frames: Dict[int, tuple] = {}
        # per segment boundary: TSDF fusion and mesh extraction seconds,
        # and the seconds of each closed-segment frame's ORB
        self.seg_timings: Dict[str, List[float]] = {
            "tsdf_fuse": [], "extract_mesh": [], "orb_frame": []}

        # render-vs-input residual panels, rendered after the optimizer of
        # frames with idx > 0 and idx % vis_freq == 0
        self.tracking_vis = self.mapping_vis = None
        tv = int(cfg["tracking"].get("vis_freq", 0) or 0)
        if tv > 0 and self.rank == 0:
            self.tracking_vis = Visualizer(
                tv, os.path.join(self.output, "tracking_vis"), self,
                verbose=self.verbose)
        mv = int(cfg["mapping"].get("vis_freq", 0) or 0)
        if mv > 0 and self.rank == 0:
            self.mapping_vis = Visualizer(
                mv, os.path.join(self.output, "mapping_vis"), self,
                verbose=self.verbose)

    # ------------------------------------------------------------------
    def _take_run_lock(self):
        """One live session per output directory (advisory flock, released
        when the process exits)."""
        import fcntl

        lock_path = os.path.join(self.output, ".run.lock")
        self._run_lock = open(lock_path, "a")
        try:
            fcntl.flock(self._run_lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._run_lock.close()
            raise RuntimeError(
                f"output directory {self.output} is already in use by a "
                "live run; pick a different output or stop the other run")
        self._run_lock.truncate(0)
        self._run_lock.write(f"{os.getpid()}\n")
        self._run_lock.flush()

    def close(self):
        """Release the output directory's run lock."""
        if getattr(self, "_run_lock", None) is not None:
            self._run_lock.close()
            self._run_lock = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def _load_pretrained_geo(self):
        path = self.cfg["pretrained_decoders"].get("middle_fine", "")
        if not path:
            return
        # relative paths resolve against the cwd, then the repo root
        cand = [path, os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            path)]
        found = next((p for p in cand if os.path.exists(p)), None)
        if found is None:
            raise FileNotFoundError(
                f"pretrained_decoders.middle_fine = {path!r} not found "
                f"(tried {cand}); clear the setting to train from "
                "random init")
        import pickle

        with open(found, "rb") as f:
            geo = pickle.load(f)  # a file of this repository
        params = dict(self.dec.geo.named_parameters())
        with torch.no_grad():
            for name, arr in _flatten(geo):
                if name in params:
                    params[name].copy_(torch.as_tensor(
                        np.asarray(arr, np.float32)))
        if self.verbose:
            print(f"Loaded pretrained geometry decoder from {found}")

    def _dynamic_radius(self, color_np):
        """The frame's (add, query) radius maps on the device, from its
        color gradient on the host; (None, None) without
        use_dynamic_radius."""
        if not self.use_dynamic_radius:
            return None, None
        pc = self.cfg["pointcloud"]
        r_add, r_query = dynamic_radius_maps(
            color_np, pc["radius_add_max"], pc["radius_add_min"],
            pc["radius_query_ratio"], pc["color_grad_threshold"])
        return (torch.as_tensor(r_add, device=self.device),
                torch.as_tensor(r_query, device=self.device))

    def _track_pixel_pool(self, color_np, depth_np) -> Optional[np.ndarray]:
        """The tracker's pool of color-gradient pixels (flat indices): the
        top 15 x pixels gradient pixels inside the ignored edges with
        depth, resampled with replacement to exactly 15 x pixels; None
        when fewer than 16 qualify."""
        t = self.cfg["tracking"]
        topts = self.topts
        flat, _ = select_pixels_by_grad(
            topts.ignore_edge_H, self.H - topts.ignore_edge_H,
            topts.ignore_edge_W, self.W - topts.ignore_edge_W,
            t["pixels"], color_np, gt_depth=depth_np,
            depth_limit=t["depth_limit"])
        self.grad_stats["track_pool"].append(int(flat.size))
        if flat.size < 16:
            return None
        # the reference resamples the pool to a fixed length (its compiled
        # program's shape); the same numpy draws keep the port's picks
        # comparable
        pool_n = 15 * t["pixels"]
        if flat.size != pool_n:
            flat = self.nprng.choice(flat, pool_n, replace=True)
        return flat

    def _grad_insert_pixels(self, color_np) -> Optional[np.ndarray]:
        """The mapper's color-gradient insertion pixels (flat indices):
        pixels_based_on_color_grad of the top gradient pixels, drawn
        without replacement (padded by repeats when fewer qualify); None
        when none does."""
        n = self.cfg["mapping"]["pixels_based_on_color_grad"]
        flat, _ = select_pixels_by_grad(0, self.H, 0, self.W, n, color_np)
        if not flat.size:
            return None
        pick = self.nprng.choice(flat.size, size=min(n, flat.size),
                                 replace=False)
        if pick.size < n:
            pick = np.concatenate([pick, pick[:n - pick.size]])
        return flat[pick]

    # ------------------------------------------------------------------
    # Tracking
    # ------------------------------------------------------------------
    def track_frame(self, idx, color, depth, color_np, depth_np
                    ) -> np.ndarray:
        """Optimize the pose of frame idx; returns the 4x4 c2w estimate.
        color_np/depth_np: the frame on the host, for the color-gradient
        pixel pool (tracking.sample_with_color_grad)."""
        t = self.cfg["tracking"]
        pre = self.estimate_c2w[idx - 1]
        if t["const_speed_assumption"] and idx >= 2:
            delta = pre @ np.linalg.inv(self.estimate_c2w[idx - 2])
            init_c2w = delta @ pre
        elif (t["visual_odometer"] and idx >= 2
              and self._prev_frame is not None):
            # direct RGB-D odometry from the previous frame as the motion
            # model; the one host read of the frame's odometry
            with self.tracer.span("track.odometry", record=self.timings
                                  .setdefault("odometry", []).append):
                pc, pd = self._prev_frame
                T = rgbd_odometry(pc, pd, color, depth,
                                  (self.fx, self.fy, self.cx, self.cy))
                init_c2w = pre @ np.linalg.inv(T.cpu().numpy())
                if self.mesh is not None:  # one motion model for every rank
                    init_c2w = self.mesh.broadcast_from_rank0(init_c2w)
        else:
            init_c2w = pre
        cam7 = torch.as_tensor(tensor_from_c2w(init_c2w), device=self.device)

        sel_i = sel_j = None
        if t["sample_with_color_grad"]:
            flat = self._track_pixel_pool(color_np, depth_np)
            if flat is not None:
                flat_t = torch.as_tensor(flat, device=self.device)
                sel_i, sel_j = flat_t % self.W, flat_t // self.W

        s = self.map_state
        kw = dict(health=self.track_health, sel_i=sel_i, sel_j=sel_j,
                  r_query=self.cur_r_query,
                  exposure_feat=(self.exposure_feat if self.encode_exposure
                                 else None))
        if self.map_sharded:
            res = msh.map_shard_track(
                self.mesh, self.dec, self._smap, color, depth, cam7,
                self.rank_draw, self.topts, self.ropts_tracker, **kw)
        elif self.ray_dp:
            res = self._track_on_rank0(color, depth, cam7, kw)
        else:
            args = (s.pos, s.grid, s.feat, color, depth, cam7)
            with self.tracer.span("track.keep"):
                self._roofline_calls["track"] = dict(
                    self._keep_call(tracker_mod.track_frame, args,
                                    (self.topts, self.ropts_tracker), kw),
                    idx=idx)
            res = tracker_mod.track_frame(
                self.dec, *args, self.draw, self.topts, self.ropts_tracker,
                **kw)
        # the tail of the frame: the results into the session, and the
        # host reads (the pose; the losses and the gate when verbose)
        with self.tracer.span("track.readback"):
            first_loss, best_loss = res.first_loss, res.best_loss
            self.track_health = res.health
            if self.encode_exposure:
                # the tracker co-optimized the latent and the exposure MLP;
                # both are shared with the mapper
                self.exposure_feat = res.exposure_feat
                with torch.no_grad():
                    for name, v in res.exposure_mlp._asdict().items():
                        getattr(self.dec.col.exposure, name).copy_(v)
            if self.verbose:
                print(f"idx:{idx}, re-rendering loss: "
                      f"{float(first_loss):.2f}->{float(best_loss):.2f}")
                th = self.track_health.cpu().numpy()
                if th[1] > self._last_rejects:
                    self._last_rejects = th[1]
                    print(f"idx:{idx}, tracking health gate: pose update "
                          f"REJECTED (total {int(th[1])}), kept "
                          f"motion-model pose; loss ema {th[0]:.3f}")
            if self.wandb.enabled:
                self.wandb.log({"idx_track": idx,
                                "tracking_loss": float(best_loss)})
            return res.c2w44.cpu().numpy()

    def _track_on_rank0(self, color, depth, cam7, kw):
        """Ray-DP tracking: rank 0 tracks on its copy of the map and
        broadcasts the result with its replicated stream's state (the other
        ranks skip the tracker and take both)."""
        res = None
        if self.rank == 0:
            s = self.map_state
            res = tracker_mod.track_frame(
                self.dec, s.pos, s.grid, s.feat, color, depth, cam7,
                self.draw, self.topts, self.ropts_tracker, **kw)
        payload = self.mesh.broadcast_from_rank0(
            None if res is None else (_to_device(res, "cpu"),
                                      self.draw.gen.get_state()))
        if res is None:
            res = _to_device(payload[0], self.device)
            self.draw.gen.set_state(payload[1])
        return res

    # ------------------------------------------------------------------
    # Map sharding: the shards are the map; map_state is their snapshot
    # ------------------------------------------------------------------
    def _sync_eval_state(self):
        """Refresh map_state's pos/feat/count/grid from every shard (a
        collective: every rank calls it at the same point). No-op when in
        step or not sharded."""
        if not self.map_sharded or not self._smap_dirty:
            return
        pos, feat, _ = msh.gather_host(self._smap, self.mesh)
        n = pos.shape[0]
        cap = int(2 ** np.ceil(np.log2(max(n + 1024, 2048))))
        state = self._device_map(pos, feat, cap)
        self.map_state = self.map_state._replace(
            pos=state.pos, feat=state.feat, count=state.count,
            grid=state.grid)
        self._count_host = n
        self._smap_dirty = False

    def _scatter_to_shards(self, pos_np, feat_np, slack: int = 24000):
        """Replace the shards with host points (segment carry-over, the
        merged map, restore), at a per-shard capacity with room for hash
        imbalance and growth."""
        n_sh = self.mesh.size()
        counts = (np.bincount(msh.owner_of_points_np(
            pos_np, self.mopts_map.cell_size, n_sh), minlength=n_sh)
            if len(pos_np) else np.zeros(n_sh, int))
        need = int(counts.max()) + max(slack // n_sh, 2048)
        cap_l = int(2 ** np.ceil(np.log2(max(need, 2048))))
        self._smap = msh.scatter_from_host(self.mesh, pos_np, feat_np, cap_l,
                                           self.mopts_map, self.device)

    def _insert_candidates_sharded(self, color, depth, cur_t, prev_t,
                                   n_rays, overlap=None, flat_idx=None):
        """Sharded insertion of n_rays sampled pixels (or the given
        color-gradient picks, gated at radius_min): the replicated
        candidates, the global gate, each point to its owner, and the
        gated locations into the replicated input cloud. Returns the
        number of locations (a device scalar)."""
        if flat_idx is None:
            rays_o, rays_d, d, c, valid, dra = \
                mapper_mod.sample_insert_candidates(
                    self.draw, color, depth, cur_t, prev_t, self.mopts,
                    n_rays, overlap, self.cur_r_add)
            r_default = self.mopts_map.radius_add
        else:
            rays_o, rays_d, d, c, valid, dra = \
                mapper_mod.pixel_insert_candidates(
                    flat_idx, color, depth, cur_t, self.mopts,
                    self.cur_r_add)
            r_default = self.mopts_map.radius_min
        r_add = (dra if dra is not None else torch.full(
            (rays_o.shape[0],), r_default, device=self.device))
        self._smap, n_loc, gate = msh.shard_add_candidates(
            self._smap, self.mesh, self.mopts_map, rays_o, rays_d, d,
            self.draw, valid, r_add)
        self._smap_dirty = True
        self.map_state = input_cloud_insert(self.map_state, self.mopts_map,
                                            rays_o, rays_d, d, c, gate)
        return n_loc

    # ------------------------------------------------------------------
    def _maybe_grow_capacity(self, headroom: int = 6000):
        """Double the point buffers when the next insertion could overflow;
        the index is rebuilt adaptively (row depth / table size escalate
        until nothing drops). Sharded: every shard doubles alike when the
        largest could overflow (a pmax), up to twice an even split of
        pointcloud.capacity."""
        if self.map_sharded:
            n_sh = self.mesh.size()
            cap_l = self._smap.pos.shape[0]
            maxcap_l = max(2 * self.mopts_map.capacity // n_sh, 2048)
            mx = int(self.mesh.pmax(self._smap.count.reshape(1)).item())
            need = mx + max(headroom // n_sh * 2, 3000)
            if need <= cap_l or cap_l >= maxcap_l:
                return
            new_cap_l = cap_l
            while need > new_cap_l and new_cap_l < maxcap_l:
                new_cap_l *= 2
            new_cap_l = min(new_cap_l, maxcap_l)
            self._smap = msh.grow_sharded(self._smap, new_cap_l,
                                          self.mopts_map)
            if self.verbose:
                print(f"grew sharded point buffer {cap_l} -> {new_cap_l} "
                      "rows a shard")
            return
        s = self.map_state
        cap = s.pos.shape[0]
        maxcap = self.mopts_map.capacity
        need = self._count_host + headroom
        if need <= cap or cap >= maxcap:
            return
        new_cap = cap
        while need > new_cap and new_cap < maxcap:
            new_cap *= 2
        new_cap = min(new_cap, maxcap)
        pos = torch.zeros((new_cap, 3), device=self.device)
        pos[:cap] = s.pos
        feat = torch.zeros((new_cap, s.feat.shape[1]), device=self.device)
        feat[:cap] = s.feat
        valid = torch.arange(new_cap, device=self.device) < s.count
        grid = knn.build_adaptive(pos, valid, self.mopts_map.cell_size,
                                  self.mopts_map.table_size,
                                  self.mopts_map.max_per_cell)
        self.map_state = s._replace(pos=pos, feat=feat, grid=grid)
        if self.verbose:
            print(f"grew point buffer {cap} -> {new_cap}")

    # ------------------------------------------------------------------
    # Submaps + loop closure
    # ------------------------------------------------------------------
    def _host_map(self):
        """(pos, feat) of the active map's valid rows, as numpy."""
        self._sync_eval_state()
        s = self.map_state
        cnt = int(s.count)
        return (s.pos[:cnt].cpu().numpy(),
                s.feat[:cnt].detach().cpu().numpy())

    def _device_map(self, npc, feat, cap: int) -> MapState:
        """A fresh map of capacity `cap` holding npc/feat as its first rows,
        indexed by build_adaptive; the input cloud carries over."""
        s = self.map_state
        state = init_map(self.mopts_map, capacity=cap, device=self.device)
        n = len(npc)
        pos, fe = state.pos, state.feat
        if n:
            pos[:n] = torch.as_tensor(npc, device=self.device)
            fe[:n] = torch.as_tensor(feat, device=self.device)
        count = torch.tensor(n, dtype=torch.int32, device=self.device)
        grid = knn.build_adaptive(
            pos, torch.arange(cap, device=self.device) < n,
            self.mopts_map.cell_size, self.mopts_map.table_size,
            self.mopts_map.max_per_cell)
        return MapState(pos=pos, feat=fe, count=count, grid=grid,
                        in_pos=s.in_pos, in_rgb=s.in_rgb,
                        in_count=s.in_count)

    def _start_new_segment(self, idx, cur_c2w, gt_c2w, color_np, depth_np):
        """Close the active segment (archive it to the host, carry over the
        points the new anchor sees) and open a new one anchored at the
        current frame."""
        first = not self.fm.fragments
        des = extract_orb(color_np, self.device)
        n_carry = 0
        if not first:
            s = self.map_state
            c_dim = self.mopts_map.c_dim
            npc, feat_host = self._host_map()
            in_cnt = int(s.in_count)
            spts = s.in_pos[self.active_sensor_start:in_cnt].cpu().numpy()
            srgb = s.in_rgb[self.active_sensor_start:in_cnt].cpu().numpy()
            carry = (self.fm.carry_over_mask(cur_c2w, npc) if len(npc)
                     else np.zeros(0, bool))
            self.fm.close_active(npc, feat_host[:, :c_dim],
                                 feat_host[:, c_dim:], spts, srgb, carry)
            # fresh active buffer seeded with the carried-over block
            n_carry = int(carry.sum())
            cap0 = max(self.initial_capacity,
                       int(2 ** np.ceil(np.log2(max(n_carry + 24000, 2)))))
            self.map_state = self._device_map(
                npc[carry], feat_host[carry],
                min(cap0, self.mopts_map.capacity))
            self._count_host = n_carry
            if self.map_sharded:  # the shards restart from the carry-over
                self._scatter_to_shards(npc[carry], feat_host[carry])
                self._smap_dirty = False
            self.keyframe_list = []  # local keyframes restart per segment
            if self.verbose:
                print(f"new segment at frame {idx} "
                      f"(carried {n_carry} points)")
        self.active_sensor_start = int(self.map_state.in_count)
        self.fm.start_fragment(idx, cur_c2w, gt_c2w, color_np, depth_np,
                               des, idx_start_features=n_carry)
        self.lc.on_new_segment(des)

    def _segment_frame(self, i):
        """A segment frame (float color, depth) from the run-loop cache,
        else loaded from the dataset. Color round-trips uint8, as on-disk
        datasets store it."""
        if i in self._seg_frames:
            c_u8, d = self._seg_frames[i]
            return c_u8.astype(np.float32) / 255.0, d
        _, c, d, _ = self.dataset[i]
        return c, d

    def _tsdf_registration_cloud(self, start_idx, end_idx):
        """Fuse a segment's frames into a TSDF on the device and return the
        mesh's vertices and colors: the segment's registration cloud. The
        grid has fixed 192^3 dims and a voxel fitted to the segment's
        bounds; registration downsamples to 0.04 m anyway."""
        frames, poses = [], []
        for i in range(start_idx, end_idx):
            frames.append(self._segment_frame(i))
            poses.append(self.estimate_c2w[i])
        lo = np.array([np.inf] * 3)
        hi = -lo
        step = max(len(frames) // 4, 1)
        for (c, d), p in zip(frames[::step], poses[::step]):
            m = d > 0
            if m.any():
                t = p[:3, 3]
                r = float(d[m].max())
                lo = np.minimum(lo, t - r)
                hi = np.maximum(hi, t + r)
        if not np.isfinite(lo).all():
            lo, hi = np.array([-3.0] * 3), np.array([3.0] * 3)
        seg = len(self.fm.fragments) - 1
        with self.tracer.span("lc.tsdf", seg=seg,
                              record=self.seg_timings["tsdf_fuse"].append):
            grid = tsdf.fuse_frames(frames, poses, self.fx, self.fy, self.cx,
                                    self.cy, voxel=self.registration_voxel,
                                    trunc=0.04, bounds=(lo, hi),
                                    fixed_dims=(192, 192, 192),
                                    device=self.device)
            self._sync()
        with self.tracer.span("lc.mesh", seg=seg,
                              record=self.seg_timings["extract_mesh"].append):
            verts, _faces, cols = tsdf.extract_mesh(grid)
        return verts, cols

    def _apply_loop_closure(self, idx) -> Optional[np.ndarray]:
        """Fuse the just-closed segment's TSDF cloud, compute its ORB
        baseline, run the correction once more than 3 segments exist, and
        apply the solved per-segment transforms rigidly to clouds,
        trajectory and the device map. Returns the corrected pose of the
        current frame, or None."""
        frags = self.fm.fragments
        old, new = frags[-2], frags[-1]
        if self.rank == 0:  # host work: rank 0 decides, the others follow
            old.reg_points, old.reg_colors = self._tsdf_registration_cloud(
                old.start_idx, new.start_idx)
            frame_des = []
            for i in range(old.start_idx + 1, new.start_idx):
                c, _ = self._segment_frame(i)
                with self.tracer.span(
                        "lc.orb", seg=len(frags) - 1, at=i,
                        record=self.seg_timings["orb_frame"].append):
                    frame_des.append(extract_orb(c, self.device))
            self.lc.compute_baseline(old.anchor_des, frame_des)
        # the closed segment's cached frames served their purpose
        for i in list(self._seg_frames):
            if i < new.start_idx:
                del self._seg_frames[i]
        if len(frags) <= 3:
            return None
        corrections = (self.lc.compute_correction() if self.rank == 0
                       else None)
        if self.mesh is not None:
            corrections = self.mesh.broadcast_from_rank0(corrections)
        if corrections is None:
            return None
        if self.verbose:
            print(f"loop closure at frame {idx}: correcting "
                  f"{len(frags)} segments")
        # trajectory snapshots around the pose-graph correction
        seg_i = len(frags) - 1
        if self.rank == 0:
            save_checkpoint(
                os.path.join(self.output, "ckpts",
                             f"{seg_i:05d}_before_pgo.pkl"),
                {"estimate_c2w_list": self.estimate_c2w.copy()})
        for i, f in enumerate(frags):
            N = corrections[i]
            last = i == len(frags) - 1
            end_idx = frags[i + 1].start_idx if not last else f.start_idx + 1
            for name in ("npc", "sensor_pts", "reg_points"):
                a = getattr(f, name)
                if a is not None and len(a):
                    setattr(f, name, a @ N[:3, :3].T + N[:3, 3])
            rng_c2w = self.estimate_c2w[f.start_idx:end_idx]
            corrected = np.einsum("ij,njk->nik", N, rng_c2w)
            corrected[:, 3] = [0, 0, 0, 1.0]
            self.estimate_c2w[f.start_idx:end_idx] = corrected
            f.anchor_est = self.estimate_c2w[f.start_idx].copy()
        # device: rigidly move the active segment's points; the move
        # re-bins them against the hash lattice, so the index is rebuilt
        # adaptively (two cells re-binned into one row can overflow it)
        N = torch.as_tensor(corrections[-1], dtype=torch.float32,
                            device=self.device)
        if self.map_sharded:
            self._smap = msh.shard_transform(self._smap, N, self.mopts_map)
            self._smap_dirty = True
        else:
            s = self.map_state
            pos = s.pos @ N[:3, :3].T + N[:3, 3]
            grid = knn.build_adaptive(pos, valid_mask(s),
                                      self.mopts_map.cell_size,
                                      self.mopts_map.table_size,
                                      self.mopts_map.max_per_cell)
            self.map_state = s._replace(pos=pos, grid=grid)
        if self.rank == 0:
            save_checkpoint(
                os.path.join(self.output, "ckpts",
                             f"{seg_i:05d}_after_pgo.pkl"),
                {"estimate_c2w_list": self.estimate_c2w.copy()})
        return self.estimate_c2w[frags[-1].start_idx].copy()

    def _build_end_state(self):
        """Merge all segments (duplicates averaged) into a fresh device map
        indexed by build_adaptive. A point the index cannot hold even after
        escalating row depth and table size would be invisible to every
        k-NN afterwards, so any drop raises."""
        c_dim = self.mopts_map.c_dim
        npc, feat_host = self._host_map()
        geo, col = feat_host[:, :c_dim], feat_host[:, c_dim:]
        if len(self.fm.fragments) > 1:
            npc, geo, col = self.fm.merged_global(npc, geo, col)
        n = len(npc)
        cap = int(2 ** np.ceil(np.log2(max(n + 1024, 2))))
        self.map_state = self._device_map(
            npc.astype(np.float32),
            np.concatenate([geo, col], axis=1).astype(np.float32), cap)
        merge_drops = int(self.map_state.grid.n_dropped)
        if merge_drops:
            raise RuntimeError(
                f"global-merge kNN rebuild dropped {merge_drops} of {n} "
                "points even after adaptive row/table escalation; raise "
                "pointcloud.cell_table_size or max_per_cell")
        self._count_host = n
        if self.verbose:
            g = self.map_state.grid
            print(f"merged global map: {n} points (index M "
                  f"{g.cell_data.shape[1]}, table {g.cell_data.shape[0] - 1})")

    # ------------------------------------------------------------------
    # Mapping
    # ------------------------------------------------------------------
    def _add_keyframe(self, idx, color, depth, cur_c2w, gt_c2w):
        if idx in self.kf_slot_of_idx:
            return
        slot = self.kf_slots_used
        if slot >= self.kf_color.shape[0]:
            return
        self.kf_slots_used += 1
        self.kf_slot_of_idx[idx] = slot
        self.kf_color[slot] = color
        self.kf_depth[slot] = depth
        if self.use_dynamic_radius:
            self.kf_rq[slot] = self.cur_r_query
        self.kf_est_c2w[idx] = cur_c2w.copy()
        self.kf_gt_c2w[idx] = gt_c2w.copy()
        if self.encode_exposure:
            self.kf_exposure[idx] = self.exposure_feat.cpu().numpy()

    def _window(self, sources: List[Optional[int]], color, depth, cur_c2w):
        """Stack the optimization window; `sources` entries are keyframe
        frame indices, or None for the current frame. Returns color,
        depth, poses and, with the dynamic radius, the query-radius maps
        (else None)."""
        def stack(ring, cur):
            return torch.stack([cur if i is None
                                else ring[self.kf_slot_of_idx[i]]
                                for i in sources])

        kc = stack(self.kf_color, color)
        kd = stack(self.kf_depth, depth)
        krq = (stack(self.kf_rq, self.cur_r_query)
               if self.use_dynamic_radius else None)
        poses = [cur_c2w if i is None else self.kf_est_c2w[i]
                 for i in sources]
        kp = torch.as_tensor(np.stack(poses).astype(np.float32),
                             device=self.device)
        return kc, kd, kp, krq

    def map_frame(self, idx, color, depth, gt_c2w, depth_np, color_np=None,
                  color_refine: bool = False):
        """Map frame idx: open a segment at a boundary, insert points, run
        loop closure, and optimize over the keyframe window. color_np (the
        frame's float RGB) is needed at segment boundaries. With
        color_refine, optimize the merged map of all segments instead (no
        insertion), over the segment anchors and this frame, 5 rounds of
        2x the iterations with the color decoder frozen."""
        cfg = self.cfg
        m = cfg["mapping"]
        init = idx == 0
        cur_c2w = self.estimate_c2w[idx]
        tr = self.tracer

        # ---------------- submap boundary ----------------
        new_fragment = False
        if self.lc_enabled and not color_refine:
            if m["segment_strategy"] == "fixed":
                size = m["fixed_segment_size"]
                new_fragment = (not self.fm.fragments) or (
                    idx % size == 0
                    and idx != self.fm.fragments[-1].start_idx)
            else:
                new_fragment = self.fm.should_start_new(cur_c2w)
            if new_fragment:
                with tr.span("lc.segment", seg=len(self.fm.fragments)):
                    self._start_new_segment(idx, cur_c2w, gt_c2w, color_np,
                                            depth_np)

        # ---------------- point insertion ----------------
        frame_pts_add = 0
        if not color_refine:
            with tr.span("map.insert"):
                self._maybe_grow_capacity()
                if init:
                    med = float(np.median(depth_np[depth_np > 0])) if (
                        depth_np > 0).any() else 2.5
                    add_n = int(np.clip(m["pixels_adding"] * (med / 2.5) ** 2,
                                        m["pixels_adding"],
                                        m["pixels_adding"] * 3))
                else:
                    add_n = m["pixels_adding"]
                cur_t = torch.as_tensor(cur_c2w, device=self.device)
                # the previous mapped pose is read fresh from the trajectory,
                # so a loop-closure correction since then is reflected
                prev_t = torch.as_tensor(
                    self.estimate_c2w[self.prev_mapped_idx]
                    if self.prev_mapped_idx is not None else cur_c2w,
                    device=self.device)
                add = mapper_mod.add_points_from_frame
                dra = self.cur_r_add
                ins = self._insert_candidates_sharded
                if self.map_sharded and m["filter_before_add_points"] \
                        and not init:
                    n_add = (ins(color, depth, cur_t, prev_t, add_n, False)
                             + ins(color, depth, cur_t, prev_t, 1000, True))
                elif self.map_sharded:
                    n_add = ins(color, depth, cur_t, prev_t, add_n)
                elif m["filter_before_add_points"] and not init:
                    self.map_state, n1 = add(
                        self.map_state, color, depth, cur_t, prev_t,
                        self.draw, self.mopts_map, self.mopts, add_n,
                        overlap=False, dynamic_r_add=dra)
                    self.map_state, n2 = add(
                        self.map_state, color, depth, cur_t, prev_t,
                        self.draw, self.mopts_map, self.mopts, 1000,
                        overlap=True, dynamic_r_add=dra)
                    n_add = n1 + n2
                else:
                    self.map_state, n_add = add(self.map_state, color, depth,
                                                cur_t, prev_t, self.draw,
                                                self.mopts_map, self.mopts,
                                                add_n, overlap=None,
                                                dynamic_r_add=dra)
                n_grad = torch.zeros_like(n_add)
                use_grad = m["pixels_based_on_color_grad"] > 0
                flat = self._grad_insert_pixels(color_np) if use_grad else None
                if flat is not None and self.map_sharded:
                    n_grad = ins(color, depth, cur_t, None, 0, flat_idx=torch.
                                 as_tensor(flat, device=self.device))
                elif flat is not None:
                    self.map_state, n_grad = mapper_mod.add_points_at_pixels(
                        self.map_state, color, depth, cur_t,
                        torch.as_tensor(flat, device=self.device), self.draw,
                        self.mopts_map, self.mopts, dynamic_r_add=dra)
                # the one host fetch of the insertion
                frame_pts_add, n_grad = torch.stack(
                    [n_add + n_grad, n_grad]).tolist()
                if use_grad:
                    self.grad_stats["map_locations"].append(n_grad)
                self._count_host += frame_pts_add * self.mopts_map.N_add
                if self.verbose:
                    print(f"{frame_pts_add} locations to add points "
                          f"(total {self._count_host}).")

        # ---------------- loop closure ----------------
        if new_fragment and len(self.fm.fragments) >= 2:
            with tr.span("map.lc", seg=len(self.fm.fragments) - 1):
                corrected = self._apply_loop_closure(idx)
                if corrected is not None:
                    self.estimate_c2w[idx] = corrected
                    cur_c2w = corrected

        with tr.span("map.window"):
            # ---------------- frustum feature selection ----------------
            if self.map_sharded:
                feat_mask = (mapper_mod.frustum_feature_mask(
                    self._smap.pos, self._smap.count,
                    torch.as_tensor(cur_c2w, device=self.device), depth,
                    self.mopts)
                    if m["frustum_feature_selection"] and not color_refine
                    else self._shard_valid())
            elif m["frustum_feature_selection"] and not color_refine:
                feat_mask = mapper_mod.frustum_feature_mask(
                    self.map_state.pos, self.map_state.count,
                    torch.as_tensor(cur_c2w, device=self.device), depth,
                    self.mopts)
            else:
                feat_mask = valid_mask(self.map_state)

            # ---------------- keyframe window ----------------
            if color_refine:
                # the merged end-state map; the window is every segment's
                # anchor frame and the current frame
                self._build_end_state()
                feat_mask = valid_mask(self.map_state)
                if self.map_sharded:  # the merged map trains on the shards
                    npc, feat_host = self._host_map()
                    self._scatter_to_shards(npc, feat_host)
                    feat_mask = self._shard_valid()
                frags = self.fm.fragments
                up = lambda a: torch.as_tensor(  # noqa: E731
                    np.stack(a).astype(np.float32), device=self.device)
                kc = torch.cat([up([f.gt_color for f in frags]), color[None]])
                kd = torch.cat([up([f.gt_depth for f in frags]), depth[None]])
                kp = up([f.anchor_est for f in frags] + [cur_c2w])
                # the reference gives every window frame the CURRENT frame's
                # query-radius map here, not each anchor's own: copied as it is
                krq = (self.cur_r_query[None].expand(kc.shape[0], -1, -1)
                       if self.use_dynamic_radius else None)
                pix_per_frame = max(m["pixels"] // 10, 1)
                exp_src = [f.start_idx for f in frags]
            else:
                k = self.mapping_window_size - 2
                window: List[Optional[int]] = []
                if len(self.keyframe_list) > 1:
                    cand = self.keyframe_list[:-1]
                    if m["keyframe_selection_method"] == "global":
                        window = cand[max(0, len(cand) - k):]
                    else:  # 'overlap'
                        sel = mapper_mod.keyframe_selection_overlap(
                            self.nprng, depth_np, cur_c2w,
                            [self.kf_est_c2w[i] for i in cand], k, self.mopts)
                        window = [cand[s] for s in sel]
                if self.keyframe_list:
                    window = window + [self.keyframe_list[-1]]
                self.selected_keyframes[idx] = [
                    {"idx": i, "est_c2w": self.kf_est_c2w[i],
                     "gt_c2w": self.kf_gt_c2w[i]} for i in window]
                # pad to the fixed window size, current frame LAST; padding
                # repeats the window cyclically (equal share per frame)
                base: List[Optional[int]] = list(window) + [None]
                n_pad = max(self.mapping_window_size - len(base), 0)
                pads = [base[i % len(base)] for i in range(n_pad)]
                window = list(window) + pads + [None]
                pix_per_frame = max(m["pixels"] // len(window), 1)
                kc, kd, kp, krq = self._window(window, color, depth, cur_c2w)
                exp_src = window[:-1]  # the last is the current frame

            # the window's exposure latents: each keyframe's own (zeros for a
            # frame without one), the current latent for the current frame
            # (the last row, which the mapper replaces by the trainable one)
            kf_exp = exp = None
            if self.encode_exposure:
                cur = self.exposure_feat.cpu().numpy()
                zeros = np.zeros_like(cur)
                rows = [cur if i is None else self.kf_exposure.get(i, zeros)
                        for i in exp_src] + [cur]
                kf_exp = torch.as_tensor(np.stack(rows), device=self.device)
                exp = self.exposure_feat

            # ---------------- iteration schedule ----------------
            num = m["iters_first"] if init else m["iters"]
            if color_refine:
                num = m["iters"] * 2  # x10 over the 5 outer rounds
            elif not init:
                num = int(np.clip(num * frame_pts_add / 300,
                                  int(m["min_iter_ratio"] * num), 2 * num))
            geo_limit = m["geo_iter_first"] if init else int(
                num * m["geo_iter_ratio"])
            n_geo = min(geo_limit + 1, num)
            n_col = num - n_geo
            table = m["init"] if init else m["stage"]
            lrs_geo = [table["geometry"]["decoders_lr"],
                       table["geometry"]["geometry_lr"],
                       table["geometry"]["color_lr"]]
            lrs_col = [table["color"]["decoders_lr"],
                       table["color"]["geometry_lr"],
                       table["color"]["color_lr"]]
            dec_mask = self.dec_mask
            if color_refine:  # the color decoder stays fixed while refining
                dec_mask = trainable_mask(self.dec, {
                    **cfg, "mapping": {**m, "fix_color_decoder": True}})

            # bundle adjustment once the window has more than 4 keyframes:
            # the window's poses train as 7-vectors; the oldest keyframe and
            # the repeats of the padded window stay fixed (only a frame's
            # first row trains)
            ba = None
            if m["BA"] and not color_refine and len(self.keyframe_list) > 4:
                kf_rows = [i for i in window if i is not None]
                oldest = min(kf_rows) if kf_rows else None
                seen = set()
                rows = []
                for i in window:
                    rows.append(1.0 if (i not in seen and i != oldest)
                                else 0.0)
                    seen.add(i)
                cams = np.stack([tensor_from_c2w(
                    cur_c2w if i is None else self.kf_est_c2w[i])
                    for i in window]).astype(np.float32)
                ba = dict(cams=torch.as_tensor(cams, device=self.device),
                          ba_row_mask=rows, ba_lr=float(m["BA_cam_lr"]),
                          ba_window=(num * (m["geo_iter_ratio"] + 0.2),
                                     num * (m["geo_iter_ratio"] + 0.3)))
                self.ba_frames.append(idx)

        # the iteration budget runs in chunks of device_chunk_iters; each
        # chunk rebuilds the ray pool (and its k-NN) and the Adam state
        # threads on; the color stage starts its leaves afresh
        # (mapper.start_color_stage; the BA poses go on), and each outer
        # round of color refinement restarts Adam (its step count included)
        chunk = int(m.get("device_chunk_iters", 64))
        feat = (self._smap.feat if self.map_sharded
                else self.map_state.feat)
        aux = None
        # a steady mapped frame keeps its last full chunk of each stage
        # for roofline()
        kept = ({} if not init and not color_refine and self.mesh is None
                else None)
        for _ in range(5 if color_refine else 1):
            st = None
            done = 0
            for g, c, first in mapper_mod.stage_chunks(n_geo, n_col, chunk):
                if c and first and st is not None:
                    st = mapper_mod.start_color_stage(
                        st, self.dec, feat.shape[1] // 2,
                        with_cams=ba is not None)
                kw = dict(kf_rq=krq, kf_exposure=kf_exp, exp=exp,
                          **({} if ba is None
                             else {**ba, "iter_offset": done}))
                if kept is not None and g + c == chunk:
                    args = (feat, st, dec_mask, feat_mask,
                            self.map_state.pos, self.map_state.grid, kc, kd,
                            kp)
                    tail = (g, c, lrs_geo, lrs_col, self.mopts,
                            self.ropts_mapper, pix_per_frame)
                    with tr.span("map.keep"):
                        kept["geo" if g else "col"] = self._keep_call(
                            mapper_mod.optimize_map, args, tail, kw)
                with tr.span("map.chunk", stage="color" if c else "geometry",
                             iters=g + c):
                    out = self._optimize(
                        feat, st, dec_mask, feat_mask, kc, kd, kp, g, c,
                        lrs_geo, lrs_col, pix_per_frame, **kw)
                feat, st, aux = out[:3]
                if self.encode_exposure:
                    exp = out[3]
                if ba is not None:
                    ba["cams"] = out[-1]
                done += g + c
        with tr.span("map.writeback"):
            if (kept is not None and ("geo" in kept or not n_geo)
                    and ("col" in kept or not n_col)):
                self._roofline_calls["map"] = dict(
                    chunks=kept, idx=idx, n_geo=n_geo, n_col=n_col,
                    chunk_iters=chunk)
            if self.map_sharded:
                self._smap = self._smap._replace(feat=feat)
                self._smap_dirty = True
            else:
                self.map_state = self.map_state._replace(feat=feat)
            if ba is not None:
                # the trained poses back into the trajectory: each keyframe's
                # estimate (its first row) and the current frame's
                new_cams = ba["cams"].cpu().numpy()
                seen = set()
                for row, i in enumerate(window):
                    if i in seen or rows[row] == 0.0:
                        continue
                    seen.add(i)
                    c2w4 = np_c2w_from_tensor(new_cams[row])
                    if i is None:
                        cur_c2w = c2w4
                        self.estimate_c2w[idx] = c2w4
                    else:
                        self.kf_est_c2w[i] = c2w4
            if self.encode_exposure:
                self.exposure_feat = exp
                if not color_refine and self.rank == 0:
                    # the latent and the color decoder this frame was mapped
                    # with, for final_eval's renders
                    self.mapped_exposure[idx] = exp.cpu().numpy()
                    cd_dir = os.path.join(self.output, "ckpts",
                                          "color_decoder")
                    os.makedirs(cd_dir, exist_ok=True)
                    save_checkpoint(os.path.join(cd_dir, f"{idx:05d}.pkl"),
                                    decoders_to_numpy(self.dec)["col"])
            if (self.verbose or self.wandb.enabled) and aux is not None:
                grid = (self._smap if self.map_sharded
                        else self.map_state).grid
                g_, c_, n_, drop = torch.stack(
                    list(aux) + [grid.n_dropped.float()]).cpu().tolist()
                if self.verbose:
                    print(f"idx: {idx}, "
                          f"geo_loss_pixel: {g_ / max(n_, 1):.6f}, "
                          f"color_loss_pixel: {c_ / max(n_, 1):.4f}, "
                          f"iters: {num}"
                          + (f", knn_dropped: {int(drop)}" if drop else ""))
                self.wandb.log({"idx_map": idx,
                                "geo_loss_pixel": g_ / max(n_, 1),
                                "color_loss_pixel": c_ / max(n_, 1),
                                "pts_total": self._count_host,
                                "knn_dropped": int(drop),
                                "num_joint_iters": num})

        # ---------------- keyframe bookkeeping ----------------
        with tr.span("map.keyframe"):
            ok_gt = np.isfinite(gt_c2w).all()
            if ((idx % self.keyframe_every == 0 or idx == self.n_img - 2)
                    and idx not in self.keyframe_list and ok_gt):
                self._add_keyframe(idx, color, depth, cur_c2w, gt_c2w)
                self.keyframe_list.append(idx)
            if ((idx % self.keyframe_global_every == 0
                 or idx == self.n_img - 2)
                    and idx not in self.keyframe_global_list and ok_gt):
                self._add_keyframe(idx, color, depth, cur_c2w, gt_c2w)
                self.keyframe_global_list.append(idx)
            self.prev_mapped_idx = idx

    def _keep_call(self, fn, args, tail, kw):
        """A hot call, fn(dec, *args, draw, *tail, **kw), kept for
        roofline(): references to its inputs (the session replaces them,
        it never writes them in place), copies of the decoders' parameters
        (which the mapper trains in place) and the draw stream's state."""
        return dict(fn=fn, args=args, tail=tail, kw=kw,
                    params=[p.detach().clone()
                            for p in self.dec.parameters()],
                    draw=self.draw.gen.get_state())

    def _time_frame(self, name, idx, seconds):
        """Record a tracked or mapped frame's wall time, and stamp it on
        the call roofline() keeps when that call is this frame's."""
        self.timings[name].append(seconds)
        kept = self._roofline_calls.get(name)
        if kept is not None and kept["idx"] == idx:
            kept["seconds"] = seconds

    def _shard_valid(self):
        return (torch.arange(self._smap.pos.shape[0], device=self.device)
                < self._smap.count)

    def _optimize(self, feat, st, dec_mask, feat_mask, kc, kd, kp, n_geo,
                  n_col, lrs_geo, lrs_col, pix_per_frame, **kw):
        """One optimize_map chunk on this session's map: the plain one, or
        on a mesh with this rank's own draws (ray-DP over the replicated
        map, or over the shards)."""
        args = (kc, kd, kp)
        tail = (n_geo, n_col, lrs_geo, lrs_col, self.mopts,
                self.ropts_mapper, pix_per_frame)
        if self.map_sharded:
            return msh.map_shard_optimize(
                self.mesh, self.dec, feat, st, dec_mask, feat_mask,
                self._smap, *args, self.rank_draw, *tail, **kw)
        s = self.map_state
        if self.ray_dp:
            return sharded_optimize_map(
                self.mesh, self.dec, feat, st, dec_mask, feat_mask, s.pos,
                s.grid, *args, self.rank_draw, *tail, **kw)
        return mapper_mod.optimize_map(
            self.dec, feat, st, dec_mask, feat_mask, s.pos, s.grid, *args,
            self.draw, *tail, **kw)

    # ------------------------------------------------------------------
    # Full-frame rendering (evaluation and visualization)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_img(self, c2w, gt_depth, chunk: int = 4096, r_query_map=None,
                   exposure_feat=None, col_params=None):
        """Full-frame render at pose c2w (4x4), in the color stage, guided
        by gt_depth (H, W) as the mapper's samples are, with the (H, W)
        query-radius map r_query_map (a device tensor or numpy; None for
        pointcloud.radius_query). With encode_exposure, exposure_feat (8,)
        is the latent whose affine the colors go through (without one the
        colors are the raw logits, as the JAX package renders them) and
        col_params (the JAX layout's color-decoder tree of numpy arrays)
        a color-decoder snapshot to render with. Returns numpy (depth
        (H, W), color (H, W, 3)).

        The frame goes through the renderer in chunks of `chunk` rays, each
        one k-NN launch over chunk * N_surface samples; the last chunk is
        padded to the full size (zero depth, so its rays are invalid), as
        the JAX package pads it. 4096, the JAX package's chunk, keeps the
        noise draws of each chunk the same shape as JAX's, so a render with
        JAX's draws replayed matches JAX's render."""
        if self._smap_dirty:
            raise RuntimeError("the map snapshot is stale: every rank calls "
                               "_sync_eval_state() before a render")
        dev = self.device
        rays_o, rays_d = get_rays(self.H, self.W, self.fx, self.fy, self.cx,
                                  self.cy, torch.as_tensor(
                                      np.asarray(c2w, np.float32), device=dev))
        rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        gd = torch.as_tensor(np.asarray(gt_depth, np.float32),
                             device=dev).reshape(-1)
        rq = (None if r_query_map is None else torch.as_tensor(
            r_query_map, dtype=torch.float32, device=dev).reshape(-1))
        n = rays_o.shape[0]
        s = self.map_state
        dec = self.dec
        if col_params is not None:
            dec = decoders_from_numpy(
                {"geo": decoders_to_numpy(self.dec)["geo"], "col": col_params},
                dev, self.cfg["model"].get("bf16_trunks", True))
        ef = (None if exposure_feat is None else torch.as_tensor(
            np.asarray(exposure_feat, np.float32), device=dev))
        depths, colors = [], []
        for i in range(0, n, chunk):
            sl = slice(i, i + chunk)
            ro, rd, d = rays_o[sl], rays_d[sl], gd[sl]
            rqc = None if rq is None else rq[sl]
            take = ro.shape[0]
            pad = chunk - take
            if pad:
                ro = torch.cat([ro, torch.zeros((pad, 3), device=dev)])
                rd = torch.cat([rd, torch.ones((pad, 3), device=dev)])
                d = torch.cat([d, torch.zeros((pad,), device=dev)])
                if rqc is not None:
                    rqc = torch.cat([rqc, torch.full((pad,), 1e-3,
                                                     device=dev)])
            dep, _, col, _ = render_batch_ray(
                dec, s.pos, s.grid, s.feat, ro, rd, d, d > 0, self.draw,
                self.ropts_mapper, "color", r_query=rqc, exposure_feat=ef)
            depths.append(dep[:take])
            colors.append(col[:take])
        depth = torch.cat(depths).reshape(self.H, self.W)
        color = torch.cat(colors).reshape(self.H, self.W, 3)
        return depth.cpu().numpy(), color.cpu().numpy()

    # ------------------------------------------------------------------
    def restore(self, ckpt_path: str) -> int:
        """Restore a live session from a checkpoint written by finalize(),
        of this package or of the JAX package (the same keys). Returns the
        frame to resume from (the checkpoint's idx + 1).

        The map is rebuilt at the capacity the growth policy gives its
        count (no clamp at pointcloud.capacity: a checkpoint written after
        the global merge can hold more) and re-indexed by build_adaptive;
        the keyframe ring is re-read from the dataset in its slot order;
        the submaps are replayed into the place-recognition database in
        order. The random streams continue where the checkpoint left them:
        the torch generator state (the port writes it as `rng_key`) and the
        numpy generator state. A JAX checkpoint's `rng_key` is a JAX key,
        which no torch generator can continue: the session then keeps its
        own generator, seeded from setup_seed. The exposure state (the
        current latent, each keyframe's and each mapped frame's) comes back
        as it was written. On a mesh every rank restores the same
        checkpoint (map sharding scatters its points to their owners) and
        each rank's own pixel stream starts again from its seed."""
        ckpt = load_checkpoint(ckpt_path)
        last_idx = int(ckpt["idx"])
        dev = self.device
        r = ckpt["resume"]
        self.exposure_feat, kf_exposure, self.mapped_exposure = \
            exposure_state_from_numpy(r, self.cfg["model"]["exposure_dim"],
                                      dev)
        self.dec = decoders_from_numpy(
            ckpt["params"], dev, self.cfg["model"].get("bf16_trunks", True))
        self.dec_mask = trainable_mask(self.dec, self.cfg)

        # ---- map buffers and index
        m = ckpt["map"]
        count = int(m["count"])
        c = self.mopts_map.c_dim
        cap = min(self.initial_capacity, self.mopts_map.capacity)
        while cap < count + 6000:
            cap *= 2
        pos = torch.zeros((cap, 3), device=dev)
        feat = torch.zeros((cap, 2 * c), device=dev)
        if count:
            pos[:count] = torch.as_tensor(np.asarray(m["pos"], np.float32))
            feat[:count, :c] = torch.as_tensor(np.asarray(m["geo"],
                                                          np.float32))
            feat[:count, c:] = torch.as_tensor(np.asarray(m["col"],
                                                          np.float32))
        grid = knn.build_adaptive(pos, torch.arange(cap, device=dev) < count,
                                  self.mopts_map.cell_size,
                                  self.mopts_map.table_size,
                                  self.mopts_map.max_per_cell)
        in_cap = self.map_state.in_pos.shape[0]
        n_in = int(r["in_count"])
        if n_in > in_cap:
            raise ValueError(
                f"checkpoint holds {n_in} input-cloud points but this "
                f"session's input capacity is {in_cap}; resuming would drop "
                "sensor points from the exported cloud: rerun with the "
                "original pointcloud capacity settings")
        in_pos = torch.zeros_like(self.map_state.in_pos)
        in_rgb = torch.zeros_like(self.map_state.in_rgb)
        if n_in:
            in_pos[:n_in] = torch.as_tensor(
                np.asarray(r["in_pos"][:n_in], np.float32))
            in_rgb[:n_in] = torch.as_tensor(
                np.asarray(r["in_rgb"][:n_in], np.float32))
        i32 = dict(dtype=torch.int32, device=dev)
        self.map_state = MapState(
            pos=pos, feat=feat, count=torch.tensor(count, **i32), grid=grid,
            in_pos=in_pos, in_rgb=in_rgb, in_count=torch.tensor(n_in, **i32))
        self._count_host = count
        if self.map_sharded:
            self._scatter_to_shards(pos[:count].cpu().numpy(),
                                    feat[:count].cpu().numpy())
            self._smap_dirty = False

        # ---- trajectories and keyframe metadata
        n = min(last_idx + 1, self.n_img)
        self.estimate_c2w[:n] = np.asarray(ckpt["estimate_c2w_list"])[:n]
        self.gt_c2w[:n] = np.asarray(ckpt["gt_c2w_list"])[:n]
        self.keyframe_global_list = list(ckpt["keyframe_list"])
        self.keyframe_list = list(r["keyframe_local_list"])
        self.kf_est_c2w = dict(ckpt["keyframe_est_c2w"])
        self.kf_gt_c2w = dict(r["kf_gt_c2w"])
        self.selected_keyframes = dict(ckpt["selected_keyframes"])
        th = np.asarray(r["track_health"], np.float32)
        if th.shape[0] == 2:  # checkpoints before the streak counter
            th = np.concatenate([th, np.zeros((1,), np.float32)])
        self.track_health = torch.as_tensor(th, device=dev)
        self._last_rejects = float(th[1])
        self.prev_mapped_idx = r["prev_mapped_idx"]

        # ---- keyframe pixel ring, re-read in the original slot order;
        # an inconsistent checkpoint fails (a dropped entry would shift
        # every later slot against the restored state)
        kf_order = list(r["kf_order"])
        missing = [i for i in kf_order if i not in self.kf_est_c2w]
        if missing:
            raise ValueError(
                f"checkpoint keyframes {missing} have no saved pose")
        if len(kf_order) > self.kf_color.shape[0]:
            raise ValueError(
                f"checkpoint holds {len(kf_order)} keyframes but this "
                f"session's ring fits {self.kf_color.shape[0]}; rerun with "
                "the original keyframe_every/--stop settings")
        self.kf_slots_used = 0
        self.kf_slot_of_idx = {}
        for kf_idx in kf_order:
            _, color_np, depth_np, _ = self.dataset[kf_idx]
            color, depth = _upload_frame(color_np, depth_np, dev)
            self.cur_r_add, self.cur_r_query = self._dynamic_radius(color_np)
            self._add_keyframe(kf_idx, color, depth, self.kf_est_c2w[kf_idx],
                               self.kf_gt_c2w.get(kf_idx,
                                                  self.kf_est_c2w[kf_idx]))
        # the ring's replay stamped the current latent; the keyframes keep
        # their own
        self.kf_exposure = kf_exposure

        # ---- submaps: the place-recognition database replayed in fragment
        # order (query ids index fragments), the score baselines restored
        self.fm.fragments = list(r["fragments"])
        self.active_sensor_start = int(r["active_sensor_start"])
        for f in self.fm.fragments:
            self.lc.on_new_segment(f.anchor_des)
        self.lc.dbow_scores = list(r.get("dbow_scores", []))

        # ---- random streams
        key = np.asarray(r.get("rng_key", np.zeros(0)))
        state = self.draw.gen.get_state()
        if key.dtype == np.uint8 and key.shape == tuple(state.shape):
            self.draw.gen.set_state(torch.as_tensor(key))
        if "np_rng_state" in r:
            self.nprng.bit_generator.state = r["np_rng_state"]

        # the visual odometer's motion model needs the previous frame, as
        # the run loop uploaded it
        if self.cfg["tracking"]["visual_odometer"] and last_idx >= 0:
            _, c_prev, d_prev, _ = self.dataset[last_idx]
            self._prev_frame = _upload_frame(c_prev, d_prev, dev)

        if self.verbose:
            print(f"resumed from {ckpt_path}: frame {last_idx}, {count} "
                  f"points, {len(self.fm.fragments)} segments, "
                  f"{self.kf_slots_used} keyframes")
        return last_idx + 1

    # ------------------------------------------------------------------
    def _vis(self, which: str, idx, iters, depth_np, color_np):
        """Residual panels of frame idx at its estimated pose, timed (on
        rank 0, from the snapshot every rank refreshes first)."""
        freq = int(self.cfg[which].get("vis_freq", 0) or 0)
        if freq <= 0 or idx == 0 or idx % freq:
            return
        self._sync_eval_state()
        vis = getattr(self, f"{which}_vis")
        if vis is None:
            return
        seconds = []
        with self.tracer.span("frame.vis", record=seconds.append,
                              which=which):
            panels = vis.vis(idx, iters - 1, depth_np, color_np,
                             self.estimate_c2w[idx],
                             r_query_map=self.cur_r_query)
        if panels is not None:
            self.timings.setdefault("vis", []).extend(seconds)

    # ------------------------------------------------------------------
    def _run_frame(self, idx, stop, progress, next_frame) -> bool:
        """One frame of run(): fetch, upload, track, map, checkpoint.
        Returns True when the run stops after it."""
        tr = self.tracer
        timings = self.timings
        if progress:
            err = (np.linalg.norm(self.estimate_c2w[idx - 1][:3, 3]
                                  - self.gt_c2w[idx - 1][:3, 3])
                   if idx > 0 else 0.0)
            print(f"[frame {idx}/{self.n_img} "
                  f"t={time.perf_counter():.0f} prev_err={err:.4f} "
                  f"pts={self._count_host} "
                  f"segs={len(self.fm.fragments)}]",
                  file=sys.stderr, flush=True)
        with tr.span("frame.data",
                     record=timings.setdefault("data", []).append):
            _, color_np, depth_np, gt_c2w = next_frame(idx)
        with tr.span("frame.upload",
                     record=timings.setdefault("upload", []).append):
            color, depth = _upload_frame(color_np, depth_np, self.device)
            if self.lc_enabled:
                self._seg_frames[idx] = (
                    np.clip(color_np * 255.0, 0, 255).astype(np.uint8),
                    depth_np)
                # bounded even when no boundary ever fires: the oldest
                # entries go (a later read reloads them)
                while len(self._seg_frames) > 600:
                    del self._seg_frames[min(self._seg_frames)]
            self.gt_c2w[idx] = gt_c2w
            self.cur_r_add, self.cur_r_query = self._dynamic_radius(
                color_np)

        if idx <= 1 or self.cfg["tracking"]["gt_camera"]:
            self.estimate_c2w[idx] = gt_c2w
        else:
            with tr.span("track", record=lambda s: self._time_frame(
                    "track", idx, s)):
                self.estimate_c2w[idx] = self.track_frame(
                    idx, color, depth, color_np, depth_np)
            self._vis("tracking", idx, self.topts.iters, depth_np, color_np)

        if idx % self.every_frame == 0 or idx == self.n_img - 1:
            if self.verbose:
                print(f"Mapping Frame {idx}")
            with tr.span("map", record=lambda s: self._time_frame(
                    "map", idx, s)):
                self.map_frame(idx, color, depth, gt_c2w, depth_np,
                               color_np)
                self._sync()
            self._vis("mapping", idx, self.cfg["mapping"]["iters"],
                      depth_np, color_np)
            if (idx == self.n_img - 1 and self.cfg["mapping"]["color_refine"]
                    and not stop):
                if self.verbose:
                    print("color_refine")
                refine = timings["color_refine"] = []
                with tr.span("map.refine", record=refine.append):
                    self.map_frame(idx, color, depth, gt_c2w, depth_np,
                                   color_np, color_refine=True)
                    self._sync()

        if self.cfg["tracking"]["visual_odometer"]:
            self._prev_frame = (color, depth)

        ckpt_freq = self.cfg["mapping"]["ckpt_freq"]
        if (self.cfg["mapping"]["save_ckpts"] and idx > 0
                and idx % ckpt_freq == 0):
            with tr.span("frame.ckpt"):
                self.finalize(idx, final=False)
        return bool(stop and idx != 0 and idx % stop == 0)

    # ------------------------------------------------------------------
    def run(self, stop: Optional[int] = None, start_idx: int = 0):
        """Track and map frames start_idx.. (0, or restore()'s return).
        Returns {"estimate_c2w", "gt_c2w", "n_points"}; per-phase wall
        times are in self.timings."""
        stop = stop or self.cfg.get("stop") or 0
        if start_idx >= self.n_img:  # a checkpoint of a finished run
            if self.verbose:
                print(f"nothing to do: the checkpoint covers all "
                      f"{self.n_img} frames")
            self.wandb.finish()
            return {"estimate_c2w": self.estimate_c2w,
                    "gt_c2w": self.gt_c2w,
                    "n_points": int(self.map_state.count)}
        import queue as _queue
        import threading as _threading

        # background frame prefetch: the procedural render (or a decode) of
        # the next frames overlaps the device work of this one
        frames_q: _queue.Queue = _queue.Queue(maxsize=2)
        stop_evt = _threading.Event()
        tr = self.tracer

        def _producer():
            for i in range(start_idx, self.n_img):
                try:
                    with tr.span("loader.frame", frame=i):
                        item = self.dataset[i]
                except Exception as e:  # noqa: BLE001 - re-raised below
                    item = e
                with tr.span("loader.put", frame=i):
                    while not stop_evt.is_set():
                        try:
                            frames_q.put((i, item), timeout=0.5)
                            break
                        except _queue.Full:
                            continue
                if stop_evt.is_set() or isinstance(item, Exception):
                    return

        prefetch_t = _threading.Thread(target=_producer, daemon=True,
                                       name="loader")
        prefetch_t.start()

        def _next_frame(idx):
            while True:
                try:
                    pf_idx, item = frames_q.get(timeout=10.0)
                    break
                except _queue.Empty:
                    if not prefetch_t.is_alive():
                        raise RuntimeError(
                            "frame prefetch thread died without delivering "
                            f"frame {idx}") from None
            if isinstance(item, Exception):
                raise RuntimeError(f"frame {pf_idx} failed to load") from item
            if pf_idx != idx:
                raise RuntimeError(f"prefetch out of order: {pf_idx} != {idx}")
            return item

        # with LOOPY_PROGRESS set, one line a frame on stderr
        progress = os.environ.get("LOOPY_PROGRESS")
        idx = start_idx
        try:
            with telemetry.active(tr):
                for idx in range(start_idx, self.n_img):
                    tr.frame = idx
                    with tr.span("frame", idx=idx):
                        done = self._run_frame(idx, stop, progress,
                                               _next_frame)
                    tr.flush()
                    if done:
                        break
        finally:
            stop_evt.set()
            prefetch_t.join(timeout=5.0)
            tr.frame = None
            tr.flush()
        self.finalize(idx)
        if self.verbose:
            reg, pgo = self.lc.registration_times, self.lc.pgo_times
            print(f"number of pgos: {len(pgo)}, average time per pgo: "
                  f"{np.mean(pgo) if pgo else float('nan'):.3f}s")
            print(f"number of registration rounds: {len(reg)}, average: "
                  f"{np.mean(reg) if reg else float('nan'):.3f}s")
            for name in ("track", "map", "color_refine", "data", "upload",
                         "vis", "odometry"):
                v = self.timings.get(name, [])
                if v:
                    print(f"{name}: n={len(v)} median "
                          f"{np.median(v) * 1e3:.0f} ms total {np.sum(v):.1f} s")
            th = self.track_health.cpu().numpy()
            print(f"tracking health gate: {int(th[1])} pose updates "
                  f"rejected (loss ema {th[0]:.3f})")
        return {
            "estimate_c2w": self.estimate_c2w[:idx + 1],
            "gt_c2w": self.gt_c2w[:idx + 1],
            "n_points": int(self.map_state.count),
        }

    # ------------------------------------------------------------------
    def roofline(self) -> Dict[str, Dict]:
        """The device work of a tracked frame and of a mapped frame,
        counted by utils/cost.CostCounter, with flops, bytes,
        transcendentals, the products' flops, the k-NN kernel's share
        (knn_flops, knn_bytes: ops/knn.query_cost) and the names of ops
        the counter has no rule for (unclassified: their bytes count,
        their flops do not), beside the frame's index (idx) and its wall
        time in run() (seconds; None for a frame not timed there).

        "track" is the last tracked frame: its k-NN pool builds and every
        iteration, forward and backward.

        "map" is the last steady mapped frame (not frame 0, not color
        refinement) that ran a full chunk of chunk_iters iterations in each
        of its stages: n_geo geometry iterations (no color loss, no color
        backward) then n_col color iterations, in optimize_map calls of at
        most chunk_iters (mapper.stage_chunks). Each stage's last full
        chunk is counted once more ("geo_chunk", "col_chunk": the counts
        of chunk_iters iterations and the chunk's own pool build), and the
        frame's count is their sum scaled by each stage's iterations:
        geo_chunk * n_geo / chunk_iters + col_chunk * n_col / chunk_iters.
        The scaling counts the pool build (its rays and its k-NN) in
        proportion to the iterations where the frame runs one a chunk, a
        partial chunk included; the k-NN is under 0.02% of a chunk's bytes
        on the card's paths, and tests/test_torch_cost.py holds the sum
        against a count of every chunk of the frame. On a bundle-adjusted
        frame every chunk trains the window's poses (BA's window sets only
        their learning rate), so the kept color chunk counts that work
        too, whether or not the window falls in it.

        Each call runs once more under the counter, on a copy of the
        decoders and a draw stream set to the captured state; the session
        is left as it was (trajectory, map, decoders, Adam states, draw
        streams, timings, the kernels' launch counts). A key is missing
        until its call ran; {} on a mesh.

        The captured inputs stay referenced until the next capture: the
        last tracked frame (color, depth, pose, pixel pool, radii) with
        the map's positions, index and features as it saw them, and the
        two chunks' window (colors, depths, poses, radius maps) with the
        map's positions and index, and the features and the Adam state at
        each chunk's start, beside a copy of the decoders each: up to about
        three map states beyond what the session itself holds.

        The JAX package's roofline() reads XLA's cost analysis instead,
        which counts the body of a lax.fori_loop once: its "track" covers
        one iteration plus the set-up, the same at any tracking.iters
        (tests/test_torch_cost.py holds both), and its "map" one of a
        chunk's iterations, which its bench.py scales by mapping.iters /
        chunk_iters. This count is the work executed: it grows with the
        iterations, so a rate divides it by the frame's own time."""
        if self.mesh is not None:
            return {}
        out = {}
        launches = (knn.KNN_SELECT_LAUNCHES.count,
                    track_render.TRACK_RENDER_LAUNCHES.count)
        try:
            track = self._roofline_calls.get("track")
            if track is not None:
                out["track"] = {**self._counts(track), "idx": track["idx"],
                                "seconds": track.get("seconds")}
            frame = self._roofline_calls.get("map")
            if frame is not None:
                out["map"] = self._frame_counts(frame)
        finally:
            (knn.KNN_SELECT_LAUNCHES.count,
             track_render.TRACK_RENDER_LAUNCHES.count) = launches
        return out

    def _counts(self, kept) -> Dict:
        """A kept call's counts (roofline()'s keys)."""
        cc = self._count_call(kept)
        knn_flops, knn_bytes = cc.reported.get("knn_select", (0, 0))
        return {"flops": cc.flops, "bytes": cc.bytes,
                "transcendentals": cc.transcendentals,
                "products": cc.products, "knn_flops": knn_flops,
                "knn_bytes": knn_bytes,
                "unclassified": sorted(cc.unclassified)}

    def _frame_counts(self, frame) -> Dict:
        """A kept mapped frame's count: each stage's chunk scaled by the
        stage's iterations over the chunk's (roofline()'s "map")."""
        C = frame["chunk_iters"]
        chunks = {s: self._counts(frame["chunks"][s])
                  for s in ("geo", "col") if s in frame["chunks"]}
        n = {"geo": frame["n_geo"], "col": frame["n_col"]}
        res = {key: round(sum(c[key] * n[s] for s, c in chunks.items()) / C)
               for key in ("flops", "bytes", "transcendentals", "products",
                           "knn_flops", "knn_bytes")}
        res["unclassified"] = sorted({u for c in chunks.values()
                                      for u in c["unclassified"]})
        for key in ("n_geo", "n_col", "chunk_iters", "idx"):
            res[key] = frame[key]
        res["seconds"] = frame.get("seconds")
        res["geo_chunk"] = chunks.get("geo")
        res["col_chunk"] = chunks.get("col")
        return res

    def _count_call(self, kept, tail=None) -> CostCounter:
        """Run a kept call (_keep_call) once more under a CostCounter, on a
        copy of the decoders with the kept parameters and a draw stream at
        the kept state; `tail` replaces the call's options."""
        dec = copy.deepcopy(self.dec)
        with torch.no_grad():
            for p, v in zip(dec.parameters(), kept["params"]):
                p.copy_(v)
        draw = TorchDraws(0, self.device)
        draw.gen.set_state(kept["draw"])
        with CostCounter() as cc:
            kept["fn"](dec, *kept["args"], draw,
                       *(kept["tail"] if tail is None else tail),
                       **kept["kw"])
        self._sync()
        return cc

    # ------------------------------------------------------------------
    def replicated_checksum(self) -> str:
        """sha256 of the state every rank of a mesh must hold alike: the
        decoders, the trajectory, the keyframe lists and poses, the health
        gate and, unless the map is sharded, the map (a single-device
        session has it too)."""
        import hashlib

        h = hashlib.sha256()
        for name, p in self.dec.named_parameters():
            h.update(name.encode())
            h.update(p.detach().cpu().numpy().tobytes())
        h.update(self.estimate_c2w.tobytes())
        h.update(repr((self.keyframe_list, self.keyframe_global_list,
                       sorted(self.kf_slot_of_idx.items()))).encode())
        for i in sorted(self.kf_est_c2w):
            h.update(np.asarray(self.kf_est_c2w[i], np.float32).tobytes())
        h.update(self.track_health.cpu().numpy().tobytes())
        if not self.map_sharded:
            s = self.map_state
            n = int(s.count)
            h.update(s.pos[:n].cpu().numpy().tobytes())
            h.update(s.feat[:n].detach().cpu().numpy().tobytes())
        return h.hexdigest()

    # ------------------------------------------------------------------
    def final_eval(self, every: Optional[int] = None, save_renders=True,
                   gt_mesh=None, n_2d_views=100) -> Dict:
        """End-of-run evaluation: render every `every`-th frame at its
        estimated pose (renders saved under rendered_every_frame/ are
        reused) -> PSNR, MS-SSIM, LPIPS, depth L1; with meshing.eval_rec,
        TSDF-fuse the renders into mesh/final_mesh.ply and, against the
        ground-truth mesh (the dataset's analytic one unless given) culled
        to the frustums of the evaluated frames, accuracy, completion,
        completion ratio, precision, recall, F-score and the 2-D depth L1
        over n_2d_views virtual views. Wall times of each step are in
        self.eval_timings."""
        every = every or self.every_frame
        rdir = os.path.join(self.output, "rendered_every_frame")
        os.makedirs(rdir, exist_ok=True)
        pairs, renders, poses = [], [], []
        n_reused = 0
        self.eval_timings: Dict[str, float] = {}
        t0 = time.perf_counter()
        for idx in range(0, self.n_img, every):
            _, gc, gd, _ = self.dataset[idx]
            cpath = os.path.join(rdir, f"color_{idx:05d}.npy")
            dpath = os.path.join(rdir, f"depth_{idx:05d}.npy")
            if save_renders and os.path.exists(cpath) \
                    and os.path.exists(dpath):
                # an earlier final_eval over the same map wrote them
                color, depth = np.load(cpath), np.load(dpath)
                n_reused += 1
            else:
                ef = col_params = None
                if self.encode_exposure:
                    # under the latent and color-decoder snapshot this frame
                    # was mapped with (the current ones when it was not)
                    ef = self.mapped_exposure.get(
                        idx, self.exposure_feat.cpu().numpy())
                    cd_path = os.path.join(self.output, "ckpts",
                                           "color_decoder", f"{idx:05d}.pkl")
                    if os.path.exists(cd_path):
                        col_params = load_checkpoint(cd_path)
                depth, color = self.render_img(
                    self.estimate_c2w[idx], gd,
                    r_query_map=self._dynamic_radius(gc)[1],
                    exposure_feat=ef, col_params=col_params)
                if save_renders:
                    np.save(cpath, color)
                    np.save(dpath, depth)
            pairs.append((color, gc, depth, gd))
            renders.append((color.astype(np.float32),
                            depth.astype(np.float32)))
            poses.append(self.estimate_c2w[idx])
        t1 = time.perf_counter()
        self.eval_timings.update(render_s=t1 - t0, frames=len(pairs),
                                 reused=n_reused)
        if self.verbose and n_reused:
            print(f"final_eval: reused {n_reused} saved renders from {rdir}")
        render_stats = evaluate_renders(
            pairs, lpips_weights=self.cfg["rendering"].get("lpips_weights"),
            device=self.device)
        self.eval_timings["image_metrics_s"] = time.perf_counter() - t1
        if self.verbose:
            print("render metrics:", render_stats)

        recon_stats = {}
        if self.cfg["meshing"]["eval_rec"]:
            t0 = time.perf_counter()
            cam = {"fx": self.fx, "fy": self.fy, "cx": self.cx,
                   "cy": self.cy, "H": self.H, "W": self.W}
            verts, faces, colors = mesh_from_renders(
                renders, poses, cam,
                voxel=self.cfg["meshing"].get("mesh_voxel", 0.02),
                device=self.device)
            os.makedirs(os.path.join(self.output, "mesh"), exist_ok=True)
            write_ply_mesh(os.path.join(self.output, "mesh",
                                        "final_mesh.ply"),
                           verts, faces, colors)
            self.eval_timings["mesh_s"] = time.perf_counter() - t0
            if gt_mesh is None and hasattr(self.dataset, "gt_mesh"):
                gt_mesh = self.dataset.gt_mesh()
            if gt_mesh is not None and len(faces):
                # against the ground-truth surface the trajectory observed
                gt_poses = [self.gt_c2w[i]
                            for i in range(0, self.n_img, every)
                            if np.isfinite(self.gt_c2w[i]).all()]
                gv, gf, _, unseen = cull_mesh(
                    gt_mesh[0], gt_mesh[1], gt_poses, cam,
                    return_unseen=True)
                t0 = time.perf_counter()
                recon_stats = calc_3d_metric((verts, faces), (gv, gf))
                t1 = time.perf_counter()
                recon_stats.update(calc_2d_metric(
                    (verts, faces), (gv, gf), n_views=n_2d_views,
                    pc_unseen=unseen))
                self.eval_timings.update(
                    metric_3d_s=t1 - t0, metric_2d_s=time.perf_counter() - t1)
                if self.verbose:
                    print("reconstruction metrics:", recon_stats)
        return {**render_stats, **recon_stats}

    # ------------------------------------------------------------------
    def finalize(self, last_idx, final: bool = True):
        """Write the input point cloud (final only) and a checkpoint with
        the JAX package's keys, as numpy (rank 0; every rank refreshes the
        map snapshot first)."""
        self._sync_eval_state()
        if self.rank != 0:
            return
        s = self.map_state
        n_in = int(s.in_count)
        n = int(s.count)
        pts = s.in_pos[:n_in].cpu().numpy()
        rgb = s.in_rgb[:n_in].cpu().numpy()
        if final:
            np.save(os.path.join(self.output, "final_point_cloud"),
                    np.hstack([pts, rgb * 255.0]))
            write_ply_points(
                os.path.join(self.output, "final_point_cloud.ply"), pts, rgb)
        c = self.mopts_map.c_dim
        feat = s.feat[:n].detach().cpu().numpy()
        ckpt = {
            "estimate_c2w_list": self.estimate_c2w,
            "gt_c2w_list": self.gt_c2w,
            "idx": last_idx,
            "params": decoders_to_numpy(self.dec),
            "map": {
                "pos": s.pos[:n].cpu().numpy(),
                "geo": feat[:, :c],
                "col": feat[:, c:],
                "count": n,
            },
            "keyframe_list": self.keyframe_global_list,
            "keyframe_est_c2w": self.kf_est_c2w,
            "selected_keyframes": self.selected_keyframes,
            "cfg": self.cfg,
            "resume": {
                "in_pos": pts, "in_rgb": rgb, "in_count": n_in,
                "keyframe_local_list": self.keyframe_list,
                "kf_gt_c2w": self.kf_gt_c2w,
                "kf_order": sorted(self.kf_slot_of_idx,
                                   key=self.kf_slot_of_idx.get),
                "kf_exposure": self.kf_exposure,
                "mapped_exposure": self.mapped_exposure,
                "exposure_feat": self.exposure_feat.cpu().numpy(),
                "track_health": self.track_health.cpu().numpy(),
                "prev_mapped_idx": self.prev_mapped_idx,
                "fragments": self.fm.fragments,
                "active_sensor_start": self.active_sensor_start,
                "dbow_scores": list(self.lc.dbow_scores),
                "rng_key": self.draw.gen.get_state().numpy(),
                "rng_pool": [],
                "np_rng_state": self.nprng.bit_generator.state,
            },
        }
        save_checkpoint(os.path.join(self.output, "ckpts",
                                     f"{last_idx:05d}.pkl"), ckpt)
        if final:
            self.wandb.finish()


def _to_device(tree, device):
    """The tensors of a nest of (named) tuples moved to `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_to_device(v, device) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


def _flatten(tree, prefix=""):
    """Pytree of arrays -> [(dotted name, array)] matching module names."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _flatten(v, f"{prefix}{k}.")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{prefix}{i}.")
        return out
    return [(prefix[:-1], tree)]
