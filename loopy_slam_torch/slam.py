"""LoopySLAM orchestrator for the port's first slice: tracking and mapping
on one device, one global map (no submaps or loop closure yet).

Port of loopy_slam_tpu/slam.py's host loop, with the same schedule:

    map(0); track(1) .. track(k*E); map(k*E); track(k*E+1) ...

Frame 0 and 1 take the ground-truth pose; every later frame is tracked from
the constant-speed motion model; every `mapping.every_frame` frames (and the
last) inserts points and optimizes the map over a keyframe window. A config
that asks for a feature outside this slice raises NotImplementedError
naming its ROADMAP.md item instead of silently running something else.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import resolve_device
from .convert import decoders_from_numpy, decoders_to_numpy
from .mapping import mapper as mapper_mod
from .mapping import tracker as tracker_mod
from .mapping.point_cloud import MapOptions, MapState, init_map, valid_mask
from .models.decoder import init_decoders, trainable_mask
from .models.renderer import RenderOptions
from .ops import knn
from .ops.camera import tensor_from_c2w
from .ops.draws import TorchDraws
from .utils.datasets import get_dataset
from .utils.io import save_checkpoint, write_ply_points


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


def _vis_fires(freq, frames) -> bool:
    return bool(freq) and freq > 0 and any(
        i > 0 and i % freq == 0 for i in frames)


def check_slice(cfg, n_frames: int) -> None:
    """Raise NotImplementedError for any configured feature the port does
    not have yet, naming its ROADMAP.md item."""
    m, t = cfg["mapping"], cfg["tracking"]
    seg = m["segment_strategy"]
    if seg not in ("rot_trans", "fixed", "none"):
        raise ValueError(f"mapping.segment_strategy={seg!r} is not one of "
                         "'rot_trans', 'fixed' or 'none'")
    every = m["every_frame"]
    mapped = [i for i in range(n_frames)
              if i % every == 0 or i == n_frames - 1]
    par = cfg.get("parallel", {})
    missing = [
        (seg != "none", f"mapping.segment_strategy={seg!r} (submaps and "
         "loop closure)", 10),
        (m["color_refine"], "mapping.color_refine", 10),
        (t["visual_odometer"], "tracking.visual_odometer", 11),
        (int(par.get("n_devices", 0)) > 1 or par.get("map_shard", False),
         "parallel.* (multi-device)", 13),
        (_vis_fires(t.get("vis_freq", 0), range(n_frames)),
         "tracking.vis_freq > 0 firing within n_frames (visualizer)", 14),
        (_vis_fires(m.get("vis_freq", 0), mapped),
         "mapping.vis_freq > 0 firing within n_frames (visualizer)", 14),
        (cfg["use_dynamic_radius"], "use_dynamic_radius", 15),
        (t["sample_with_color_grad"], "tracking.sample_with_color_grad", 15),
        (m["pixels_based_on_color_grad"] > 0,
         "mapping.pixels_based_on_color_grad > 0", 15),
        (cfg["model"]["encode_exposure"], "model.encode_exposure", 16),
        (m["BA"], "mapping.BA", 17),
        (cfg["rendering"]["sample_near_pcl"], "rendering.sample_near_pcl", 18),
        (cfg["wandb"], "wandb", 19),
    ]
    for on, what, item in missing:
        if on:
            raise NotImplementedError(
                f"{what} is not ported to loopy_slam_torch yet "
                f"(ROADMAP.md Queue 1 item {item})")


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
                 device=None, init_params=None):
        """cfg: a loaded config. device: None for the CUDA card (raises
        without one), or e.g. "cpu". init_params: optional decoder pytree
        of numpy arrays (JAX layout) to start from instead of a random
        init; the pretrained geometry trunk still loads over it."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.verbose = cfg["verbose"]
        self.output = output or cfg["data"]["output"]

        cam = update_cam(cfg)
        self.H, self.W = cam["H"], cam["W"]
        self.fx, self.fy = cam["fx"], cam["fy"]
        self.cx, self.cy = cam["cx"], cam["cy"]

        self.dataset = get_dataset(cfg)
        self.n_img = len(self.dataset)
        check_slice(cfg, self.n_img)

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
        self.nprng = np.random.default_rng(seed)

        bf16 = cfg["model"].get("bf16_trunks", True)
        if init_params is None:
            self.dec = init_decoders(self.draw.gen, cfg, self.device)
        else:
            self.dec = decoders_from_numpy(init_params, self.device, bf16)
        self._load_pretrained_geo()
        self.dec_mask = trainable_mask(self.dec, cfg)

        self.initial_capacity = int(cfg["pointcloud"].get(
            "initial_capacity", 2 ** 15))
        self.map_state: MapState = init_map(
            self.mopts_map, capacity=min(self.initial_capacity,
                                         self.mopts_map.capacity),
            device=self.device)
        self._count_host = 0  # host shadow of map_state.count

        self.estimate_c2w = np.zeros((self.n_img, 4, 4), np.float32)
        self.gt_c2w = np.zeros((self.n_img, 4, 4), np.float32)

        m = cfg["mapping"]
        self.every_frame = m["every_frame"]
        self.keyframe_every = m["keyframe_every"]
        self.keyframe_global_every = m["keyframe_global_every"]
        self.mapping_window_size = m["mapping_window_size"] * (
            2 if self.n_img > 4000 else 1)

        # keyframe pixels on the device, poses on the host
        kf_cap = self.n_img // min(self.keyframe_every,
                                   self.keyframe_global_every) + 4
        self.kf_color = torch.zeros((kf_cap, self.H, self.W, 3),
                                    device=self.device)
        self.kf_depth = torch.zeros((kf_cap, self.H, self.W),
                                    device=self.device)
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

    # ------------------------------------------------------------------
    # Tracking
    # ------------------------------------------------------------------
    def track_frame(self, idx, color, depth) -> np.ndarray:
        """Optimize the pose of frame idx; returns the 4x4 c2w estimate."""
        t = self.cfg["tracking"]
        pre = self.estimate_c2w[idx - 1]
        if t["const_speed_assumption"] and idx >= 2:
            delta = pre @ np.linalg.inv(self.estimate_c2w[idx - 2])
            init_c2w = delta @ pre
        else:
            init_c2w = pre
        cam7 = torch.as_tensor(tensor_from_c2w(init_c2w), device=self.device)
        s = self.map_state
        (_, best_c2w44, first_loss, best_loss,
         self.track_health) = tracker_mod.track_frame(
            self.dec, s.pos, s.grid, s.feat, color, depth, cam7, self.draw,
            self.topts, self.ropts_tracker, health=self.track_health)
        if self.verbose:
            print(f"idx:{idx}, re-rendering loss: "
                  f"{float(first_loss):.2f}->{float(best_loss):.2f}")
            th = self.track_health.cpu().numpy()
            if th[1] > self._last_rejects:
                self._last_rejects = th[1]
                print(f"idx:{idx}, tracking health gate: pose update "
                      f"REJECTED (total {int(th[1])}), kept motion-model "
                      f"pose; loss ema {th[0]:.3f}")
        return best_c2w44.cpu().numpy()

    # ------------------------------------------------------------------
    def _maybe_grow_capacity(self, headroom: int = 6000):
        """Double the point buffers when the next insertion could overflow;
        the index is rebuilt adaptively (row depth / table size escalate
        until nothing drops)."""
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
        self.kf_est_c2w[idx] = cur_c2w.copy()
        self.kf_gt_c2w[idx] = gt_c2w.copy()

    def _window(self, sources: List[Optional[int]], color, depth, cur_c2w):
        """Stack the optimization window; `sources` entries are keyframe
        frame indices, or None for the current frame."""
        kc = torch.stack([color if i is None
                          else self.kf_color[self.kf_slot_of_idx[i]]
                          for i in sources])
        kd = torch.stack([depth if i is None
                          else self.kf_depth[self.kf_slot_of_idx[i]]
                          for i in sources])
        poses = [cur_c2w if i is None else self.kf_est_c2w[i]
                 for i in sources]
        kp = torch.as_tensor(np.stack(poses).astype(np.float32),
                             device=self.device)
        return kc, kd, kp

    def map_frame(self, idx, color, depth, gt_c2w, depth_np):
        cfg = self.cfg
        m = cfg["mapping"]
        init = idx == 0
        cur_c2w = self.estimate_c2w[idx]

        # ---------------- point insertion ----------------
        self._maybe_grow_capacity()
        if init:
            med = float(np.median(depth_np[depth_np > 0])) if (
                depth_np > 0).any() else 2.5
            add_n = int(np.clip(m["pixels_adding"] * (med / 2.5) ** 2,
                                m["pixels_adding"], m["pixels_adding"] * 3))
        else:
            add_n = m["pixels_adding"]
        cur_t = torch.as_tensor(cur_c2w, device=self.device)
        prev_t = torch.as_tensor(
            self.estimate_c2w[self.prev_mapped_idx]
            if self.prev_mapped_idx is not None else cur_c2w,
            device=self.device)
        add = mapper_mod.add_points_from_frame
        if m["filter_before_add_points"] and not init:
            self.map_state, n1 = add(self.map_state, color, depth, cur_t,
                                     prev_t, self.draw, self.mopts_map,
                                     self.mopts, add_n, overlap=False)
            self.map_state, n2 = add(self.map_state, color, depth, cur_t,
                                     prev_t, self.draw, self.mopts_map,
                                     self.mopts, 1000, overlap=True)
            n_add = n1 + n2
        else:
            self.map_state, n_add = add(self.map_state, color, depth, cur_t,
                                        prev_t, self.draw, self.mopts_map,
                                        self.mopts, add_n, overlap=None)
        frame_pts_add = int(n_add)  # the one host fetch of the insertion
        self._count_host += frame_pts_add * self.mopts_map.N_add
        if self.verbose:
            print(f"{frame_pts_add} locations to add points "
                  f"(total {self._count_host}).")

        # ---------------- frustum feature selection ----------------
        if m["frustum_feature_selection"]:
            feat_mask = mapper_mod.frustum_feature_mask(
                self.map_state.pos, self.map_state.count, cur_t, depth,
                self.mopts)
        else:
            feat_mask = valid_mask(self.map_state)

        # ---------------- keyframe window ----------------
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
        # pad to the fixed window size, current frame LAST; padding repeats
        # the window cyclically (equal share per frame, approximately)
        base: List[Optional[int]] = list(window) + [None]
        n_pad = max(self.mapping_window_size - len(base), 0)
        pads = [base[i % len(base)] for i in range(n_pad)]
        window = list(window) + pads + [None]
        pix_per_frame = max(m["pixels"] // len(window), 1)
        kc, kd, kp = self._window(window, color, depth, cur_c2w)

        # ---------------- iteration schedule ----------------
        num = m["iters_first"] if init else m["iters"]
        if not init:
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

        # the iteration budget runs in chunks of device_chunk_iters; each
        # chunk rebuilds the ray pool (and its k-NN), Adam state threads on
        chunk = int(m.get("device_chunk_iters", 64))
        feat = self.map_state.feat
        st = None
        aux = None
        done_geo, done_col = 0, 0
        while done_geo + done_col < n_geo + n_col:
            g = min(chunk, n_geo - done_geo)
            c = min(chunk - g, n_col - done_col)
            feat, st, aux = mapper_mod.optimize_map(
                self.dec, feat, st, self.dec_mask, feat_mask,
                self.map_state.pos, self.map_state.grid, kc, kd, kp,
                self.draw, g, c, lrs_geo, lrs_col, self.mopts,
                self.ropts_mapper, pix_per_frame)
            done_geo += g
            done_col += c
        self.map_state = self.map_state._replace(feat=feat)
        if self.verbose and aux is not None:
            g_, c_, n_, drop = torch.stack(
                list(aux) + [self.map_state.grid.n_dropped.float()]
            ).cpu().tolist()
            print(f"idx: {idx}, geo_loss_pixel: {g_ / max(n_, 1):.6f}, "
                  f"color_loss_pixel: {c_ / max(n_, 1):.4f}, iters: {num}"
                  + (f", knn_dropped: {int(drop)}" if drop else ""))

        # ---------------- keyframe bookkeeping ----------------
        ok_gt = np.isfinite(gt_c2w).all()
        if ((idx % self.keyframe_every == 0 or idx == self.n_img - 2)
                and idx not in self.keyframe_list and ok_gt):
            self._add_keyframe(idx, color, depth, cur_c2w, gt_c2w)
            self.keyframe_list.append(idx)
        if ((idx % self.keyframe_global_every == 0 or idx == self.n_img - 2)
                and idx not in self.keyframe_global_list and ok_gt):
            self._add_keyframe(idx, color, depth, cur_c2w, gt_c2w)
            self.keyframe_global_list.append(idx)
        self.prev_mapped_idx = idx

    # ------------------------------------------------------------------
    def run(self, stop: Optional[int] = None):
        """Track and map every frame. Returns {"estimate_c2w", "gt_c2w",
        "n_points"}; per-phase wall times are in self.timings."""
        stop = stop or self.cfg.get("stop") or 0
        import queue as _queue
        import threading as _threading

        # background frame prefetch: the procedural render (or a decode) of
        # the next frames overlaps the device work of this one
        frames_q: _queue.Queue = _queue.Queue(maxsize=2)
        stop_evt = _threading.Event()

        def _producer():
            for i in range(self.n_img):
                try:
                    item = self.dataset[i]
                except Exception as e:  # noqa: BLE001 - re-raised below
                    item = e
                while not stop_evt.is_set():
                    try:
                        frames_q.put((i, item), timeout=0.5)
                        break
                    except _queue.Full:
                        continue
                if stop_evt.is_set() or isinstance(item, Exception):
                    return

        prefetch_t = _threading.Thread(target=_producer, daemon=True)
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

        idx = 0
        try:
            for idx in range(self.n_img):
                t_f = time.perf_counter()
                _, color_np, depth_np, gt_c2w = _next_frame(idx)
                self.timings.setdefault("data", []).append(
                    time.perf_counter() - t_f)
                t_f = time.perf_counter()
                color, depth = _upload_frame(color_np, depth_np, self.device)
                self.gt_c2w[idx] = gt_c2w
                self.timings.setdefault("upload", []).append(
                    time.perf_counter() - t_f)

                if idx <= 1 or self.cfg["tracking"]["gt_camera"]:
                    self.estimate_c2w[idx] = gt_c2w
                else:
                    t0 = time.perf_counter()
                    self.estimate_c2w[idx] = self.track_frame(idx, color,
                                                              depth)
                    self.timings["track"].append(time.perf_counter() - t0)

                if idx % self.every_frame == 0 or idx == self.n_img - 1:
                    if self.verbose:
                        print(f"Mapping Frame {idx}")
                    t0 = time.perf_counter()
                    self.map_frame(idx, color, depth, gt_c2w, depth_np)
                    self._sync()
                    self.timings["map"].append(time.perf_counter() - t0)

                ckpt_freq = self.cfg["mapping"]["ckpt_freq"]
                if (self.cfg["mapping"]["save_ckpts"] and idx > 0
                        and idx % ckpt_freq == 0):
                    self.finalize(idx, final=False)
                if stop and idx != 0 and idx % stop == 0:
                    break
        finally:
            stop_evt.set()
            prefetch_t.join(timeout=5.0)
        self.finalize(idx)
        if self.verbose:
            for name in ("track", "map", "data", "upload"):
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
    def finalize(self, last_idx, final: bool = True):
        """Write the input point cloud (final only) and a checkpoint with
        the JAX package's keys, as numpy."""
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
                "kf_exposure": {},
                "mapped_exposure": {},
                "exposure_feat": np.zeros(
                    (self.cfg["model"]["exposure_dim"],), np.float32),
                "track_health": self.track_health.cpu().numpy(),
                "prev_mapped_idx": self.prev_mapped_idx,
                "fragments": [],
                "active_sensor_start": 0,
                "dbow_scores": [],
                "rng_key": self.draw.gen.get_state().numpy(),
                "rng_pool": [],
                "np_rng_state": self.nprng.bit_generator.state,
            },
        }
        save_checkpoint(os.path.join(self.output, "ckpts",
                                     f"{last_idx:05d}.pkl"), ckpt)


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
