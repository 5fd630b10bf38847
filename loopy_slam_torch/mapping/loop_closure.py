"""Loop closure: place-recognition proposals, pairwise registration,
statistical edge filtering, pose-graph solve, rigid correction.

Port of loopy_slam_tpu/mapping/loop_closure.py. Registration runs on the
host (numpy/scipy in a spawn pool, as in the JAX package); the pose-graph
solve runs in float32 on the session's device, on the graph as given.

Behavioral port of the reference's compute_correction / apply_correction
(reference src/neural_point.py:602-951,144-232) on top of this framework's
own registration (ops/registration.py) and pose-graph solver
(ops/pose_graph.py) instead of Open3D, and ORB matching scores
(mapping/place_recognition.py) instead of DBoW3.

The edge-filter cascade is reproduced exactly (default path: filter=True,
old_trans_mag_filter=True — neural_point.py:681-916):
  * loop-edge translation magnitudes; 90th-percentile distance gate with
    a 20th-percentile fitness floor marks "good far" edges;
  * iterative 97.5->0 percentile shrinking of the remaining magnitudes
    until their std <= iter_std_thresh, yielding mag_thresh;
  * a loop edge enters the graph iff success AND (std <= std_threshold OR
    (transl_mag < mag_thresh AND fitness >= fitness_thresh));
  * no accepted edge touches the newest segment -> abort (return None).

Pose-graph convention: nodes are per-segment rigid CORRECTIONS (all
initialized to identity; odometry edges measure identity), matching the
reference's graph of identity nodes (neural_point.py:616-618) — the solved
node poses are applied directly to segment points and cameras.
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from .. import resolve_device
from ..ops import registration as reg
from ..ops.pose_graph import PoseGraph, optimize
from . import place_recognition as pr
from .fragments import FragmentManager


@dataclass
class LoopClosureConfig:
    registration_method: str = "robust_icp"
    global_iter: int = 100000
    conf: float = 0.999
    filter: bool = True
    orb_filter: bool = True
    mult_dbow: float = 1.0
    min_dist: int = 1
    kval: int = 2
    trans_mag_percentile: float = 90
    iter_std_thresh: float = 0.15
    std_threshold: float = 0.04
    fitness_thresh: float = 0.1
    prune_pgo: float = 0.25
    lc_pref: float = 5.0
    n_jobs: int = 8

    @staticmethod
    def from_cfg(cfg):
        t = cfg["tracking"]
        return LoopClosureConfig(
            global_iter=min(int(t["global_iter"]), 200000),
            conf=float(t["global_reg_conf"]),
            filter=bool(t["filter"]),
            orb_filter=bool(t["dbow_filter"]),
            mult_dbow=float(t["mult_dbow"]),
            min_dist=int(t["min_dist"]),
            kval=int(t["kval"]),
            trans_mag_percentile=float(t["trans_mag_percentile"]),
            iter_std_thresh=float(t["iter_std_thresh"]),
            std_threshold=float(t["std_threshold"]),
            fitness_thresh=float(t["fitness_thresh"]),
            prune_pgo=float(t["prune_pgo"]),
            lc_pref=float(t["lc_pref"]),
        )


# the worker lives in its own module so spawned pool interpreters import
# only numpy/scipy and a torch without a CUDA context (see _reg_worker.py)
from ._reg_worker import register_one as _register_one  # noqa: E402


class LoopCloser:
    def __init__(self, cfg: LoopClosureConfig, fm: FragmentManager,
                 device=None):
        self.cfg = cfg
        self.fm = fm
        self.device = resolve_device(device)
        self.db = pr.ScoreDB(device=self.device)
        self.dbow_scores: List[float] = []
        self.registration_times: List[float] = []
        self.pgo_times: List[float] = []
        # per-round edge diagnostics (reference compute_odometry_errors /
        # compute_loop_errors, neural_point.py:234-344): filled by
        # compute_correction, printed by the session when verbose
        self.last_diag: List[Dict] = []
        # one record per compute_correction call that had >= 3 closed
        # segments: edges proposed, whether one is a loop edge on the
        # newest closed segment, edges accepted, whether the pose graph
        # was solved and its correction applied, the largest translation
        self.rounds: List[Dict] = []

    # -- called at each new-segment event ------------------------------
    def on_new_segment(self, anchor_des):
        self.db.add(anchor_des)

    def compute_baseline(self, old_anchor_des, frame_des_list):
        self.dbow_scores.append(pr.baseline_score(
            old_anchor_des, frame_des_list, device=self.device))

    # -- proposal + registration + filter + solve ----------------------
    def compute_correction(self) -> Optional[np.ndarray]:
        """Returns per-fragment 4x4 correction transforms (F, 4, 4) for ALL
        fragments (the newest reuses its predecessor's), or None."""
        import time

        fm = self.fm
        cfg = self.cfg
        frags = fm.fragments[:-1]  # use_old_segments_only=True
        n = len(frags)
        if n < 3:
            return None
        rnd = {"closed_segments": n, "edges_proposed": 0,
               "loop_edges_proposed": 0, "newest_has_loop_edge": False,
               "edges_accepted": 0, "solved": False, "applied": False,
               "max_correction_m": None}
        self.rounds.append(rnd)

        pairs: List[Tuple[int, int]] = []
        last_segment_loop_edge = False
        for s in range(n):
            if s + 1 < n:
                pairs.append((s, s + 1))
            results = self.db.query(frags[s].anchor_des, cfg.kval)
            score_floor = (cfg.mult_dbow * self.dbow_scores[s]
                           if (cfg.orb_filter and s < len(self.dbow_scores))
                           else -np.inf)
            for r in results:
                if (abs(r.Id - s) > cfg.min_dist and r.Id < n
                        and (not cfg.orb_filter or r.Score > score_floor)):
                    if r.Id == n - 1 or s == n - 1:
                        last_segment_loop_edge = True
                    pairs.append((s, int(r.Id)))
        rnd["edges_proposed"] = len(pairs)
        rnd["loop_edges_proposed"] = len(pairs) - (n - 1)
        # without a loop edge on the newest closed segment the round stops
        # here, before registration
        rnd["newest_has_loop_edge"] = last_segment_loop_edge
        if not last_segment_loop_edge:
            return None

        def seg_dict(i):
            f = frags[i]
            pts = f.reg_points if f.reg_points is not None else f.sensor_pts
            cols = (f.reg_colors if f.reg_colors is not None
                    else f.sensor_rgb)
            return {"points": pts, "points_color": cols,
                    "keyframe": f.anchor_est, "gt_camera": f.anchor_gt}

        jobs = [(s, t, seg_dict(s), seg_dict(t),
                 "identity" if s + 1 == t else cfg.registration_method,
                 cfg.global_iter, cfg.conf, 1000 + 13 * s + t)
                for (s, t) in pairs]
        tic = time.perf_counter()
        # pool only pays when real parallelism exists: each spawned worker
        # costs a full interpreter + module imports (~1 min CPU), so on a
        # 1-CPU host an 8-way pool turns a seconds-long registration batch
        # into a >10-minute stall. Cap by available cores and job count.
        n_workers = min(cfg.n_jobs, os.cpu_count() or 1, len(jobs))
        if n_workers > 1 and len(jobs) > 2:
            # spawn, not fork: the parent holds a CUDA context and torch
            # threads. Unlike the JAX package, no environment scrub is
            # needed: the workers import no accelerator runtime. A failed
            # pool (a worker killed, a host without semaphores) falls back
            # to registering in this process: the same host code makes the
            # same edges, so the fallback hides no device.
            import multiprocessing as _mp

            try:
                with ProcessPoolExecutor(
                        max_workers=n_workers,
                        mp_context=_mp.get_context("spawn")) as ex:
                    results = list(ex.map(_register_one, jobs))
            except Exception as e:
                print(f"registration pool failed ({type(e).__name__}); "
                      "falling back to in-process registration")
                results = [_register_one(j) for j in jobs]
        else:
            results = [_register_one(j) for j in jobs]
        self.registration_times.append(time.perf_counter() - tic)

        edges = []  # (s, t, T, info, certain, fitness, transl_mag, success)
        for (s, t), out in zip(pairs, results):
            edges.append({
                "s": s, "t": t, "T": out["transformation"],
                # loop edges carry point-to-plane information when the
                # registration produced it: directions the submap geometry
                # does not constrain (planar slides) then weigh ~nothing
                # in the solve (ops/registration.information_matrix_p2plane)
                "info": out.get("information_pp", out["information"]),
                "odom": t == s + 1,
                "fitness": out.get("fitness", -1.0),
                "transl_mag": float(np.abs(
                    out["transformation"][:3, 3]).mean()),
                "success": out["success"],
                # GT-referenced edge error (diagnostic only — the reference
                # logs the same via compute_loop_errors, neural_point.py:274)
                "transl_err": out.get("transformation_transl_err", -1.0),
            })

        # ---- statistical filter cascade (neural_point.py:681-916) ----
        loop_edges = [e for e in edges if not e["odom"]]
        accepted: List[Dict] = [e for e in edges if e["odom"] and e["success"]]
        valid_last = False
        if cfg.filter and loop_edges:
            dist = np.array([abs(e["s"] - e["t"]) for e in loop_edges])
            fit = np.array([e["fitness"] for e in loop_edges])
            mags = np.array([e["transl_mag"] for e in loop_edges])
            distance_thresh = np.percentile(dist, 90)  # hardcoded in ref :690
            fitness_low = np.percentile(fit, 20)
            good_far = (dist > distance_thresh) & (fit > fitness_low)
            rest = mags[~good_far]
            iter_std = rest.std() if rest.size else 0.0
            std_trans = iter_std
            mag_thresh_temp = rest.max() if rest.size else 0.0
            pct = 97.5
            while iter_std > cfg.iter_std_thresh and pct > 0 and rest.size:
                mag_thresh_temp = np.percentile(rest, pct)
                rest = rest[rest < mag_thresh_temp]
                iter_std = rest.std() if rest.size else 0.0
                pct -= 2.5
            for e in loop_edges:
                take = e["success"] and (
                    std_trans <= cfg.std_threshold
                    or (e["transl_mag"] < mag_thresh_temp
                        and e["fitness"] >= cfg.fitness_thresh))
                if take:
                    accepted.append(e)
                    if e["s"] == n - 1 or e["t"] == n - 1:
                        valid_last = True
        else:
            for e in loop_edges:
                if e["success"]:
                    accepted.append(e)
            valid_last = True
        acc_ids = {id(e) for e in accepted}
        rnd["edges_accepted"] = len(accepted)
        self.last_diag = [dict(e, accepted=id(e) in acc_ids, T=None,
                               info=None) for e in edges]
        for e in sorted(self.last_diag, key=lambda e: -e["transl_err"]):
            kind = "odom" if e["odom"] else "loop"
            print(f"  LC edge {e['s']:2d}->{e['t']:2d} {kind} "
                  f"fit={e['fitness']:.3f} mag={e['transl_mag']:.3f} "
                  f"err_vs_gt={e['transl_err']:.3f} "
                  f"{'ACCEPT' if e['accepted'] else 'reject'}")
        if not valid_last:
            return None

        # ---- pose-graph solve over correction nodes -------------------
        # edge convention: o3d edge (s, t, T) constrains X_s = X_t @ T,
        # i.e. our residual edge i=t -> j=s with Z = T
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        g = PoseGraph(
            nodes=torch.eye(4, **f32).repeat(n, 1, 1),
            edge_i=torch.tensor([e["t"] for e in accepted], device=dev),
            edge_j=torch.tensor([e["s"] for e in accepted], device=dev),
            edge_z=torch.as_tensor(np.stack([e["T"] for e in accepted])
                                   .astype(np.float32), device=dev),
            edge_info=torch.as_tensor(np.stack(
                [reg.info_o3d_to_rho_phi(e["info"]) for e in accepted])
                .astype(np.float32), device=dev),
            certain=torch.tensor([e["odom"] for e in accepted], device=dev))
        tic = time.perf_counter()
        solved, _ = optimize(g, preference_loop_closure=cfg.lc_pref,
                                   max_iters=40)
        solved = solved.cpu().numpy()
        self.pgo_times.append(time.perf_counter() - tic)

        # sanity gate: a diverged solve must never be applied — corrections
        # are small rigid nudges, not teleports
        max_t = float(np.abs(solved[:, :3, 3]).max())
        rnd.update(solved=True, max_correction_m=max_t)
        if not np.isfinite(solved).all() or max_t > 5.0:
            print(f"pose-graph solve rejected (max correction {max_t:.2f} m)")
            return None

        # corrections for ALL fragments; the active (never-registered)
        # segment reuses its predecessor's node (apply_correction,
        # neural_point.py:164-170)
        corrections = np.concatenate([solved, solved[-1:]], axis=0)
        rnd["applied"] = True
        return corrections
