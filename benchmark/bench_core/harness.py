"""One benchmark run: a cell's sequence written from the seed, the
program's own loop (`LoopySLAM.run`) driven over it, the window measured in
whole mapping cycles, the window's work checked against the plain
reference, and the result line.

Everything specific to a cell is found by name: the cell in
`BENCHMARK.json`, its configuration's file, `traffic/<mix>.json`, and each
metric's reader `metrics/<metric>.py`. Nothing here names a cell.

The program is driven, never edited. The benchmark wraps, from outside:
  * the session's `track_frame` and `map_frame` (instance attributes), for
    the spans that give frame boundaries, and to close the window: the
    first mapped frame that ends at or after `seconds` into the window
    raises `WindowClosed` out of `LoopySLAM.run`, whose own `finally`
    stops its prefetch thread;
  * `ops.knn.query_chunked`, `mapping.tracker.tracking_loss_cached`,
    `mapping.mapper._map_loss_pool`, `mapping.mapper.optimize_map` and
    `ops.adam.update` (module attributes, looked up by the program at call
    time), to capture the few iterations the check compares, each with the
    iteration after it. The wrappers restore the originals when the run
    ends.

The iterations that the per-layer metrics count come from the
configuration: a tracked frame runs `tracking.iters`, a mapped frame the
mapping schedule of the points it added (the program's point count read
around its `map_frame` span). The count at the wrapped entry points is
printed beside it as a cross-check.
"""

from __future__ import annotations

import copy
import hashlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check as check_mod
from .flops import PEAK_F32_FLOPS, iteration_flops, knn_bound_s, \
    knn_query_cost
from .sequence import write_sequence
from .check import ref_frames

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "loopy_slam_tpu")


class WindowClosed(Exception):
    """Raised out of the program's loop when the window is over."""


class SequenceTooShort(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Finding a cell's files by name
# ---------------------------------------------------------------------------

def load_cell(name: str, spec_path: Optional[str] = None) -> Dict:
    """The cell `name` of BENCHMARK.json with its configuration's file and
    its traffic mix, read from the benchmark folder beside the spec."""
    spec_path = spec_path or os.path.join(REPO_DIR, "BENCHMARK.json")
    root = os.path.dirname(os.path.abspath(spec_path))
    with open(spec_path) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {spec_path}")
    cell = cells[name]
    confs = {c["name"]: c for c in spec["configs"]}
    conf = confs[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    bench_dir = os.path.join(root, spec["paths"][0])
    with open(os.path.join(bench_dir, "traffic",
                           f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    metrics = []
    for group in ("end_to_end", "per_layer"):
        for m in spec[group]:
            if "workloads" in m and name not in m["workloads"]:
                continue
            metrics.append(dict(m, group=group, reader=os.path.join(
                bench_dir, "metrics", f"{m['name']}.py")))
    return {"name": name, "cell": cell, "conf": conf, "config": config,
            "traffic": traffic, "metrics": metrics, "bench_dir": bench_dir,
            "root": root, "run_seconds": spec["run_seconds"]}


def read_metric(path: str, run) -> Optional[float]:
    """Call the reader `read(run)` of one metric's file."""
    spec = importlib.util.spec_from_file_location(
        "metric_" + hashlib.sha1(path.encode()).hexdigest()[:12], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def update_recursive(d: Dict, u: Dict) -> None:
    for k, v in u.items():
        if isinstance(v, dict) and isinstance(d.get(k), dict):
            update_recursive(d[k], v)
        else:
            d[k] = v


def seeds(seed: int, n_sequences: int) -> Dict[str, int]:
    """The run's independent streams, all from --seed: which of the mix's
    sequences it runs, the program's seed (its weights and draws) and
    the check's choice of the iterations it compares."""
    def draw(tag, hi):
        return int(np.random.default_rng([seed, tag]).integers(0, hi))
    return {"sequence": draw(1, n_sequences), "program": draw(2, 2 ** 31),
            "check": draw(4, 2 ** 31)}


# ---------------------------------------------------------------------------
# The sequence: written from the seed, cached in the checkout per cell
# ---------------------------------------------------------------------------

def prepare_sequence(c: Dict, cfg: Dict, which: int, workers: int,
                     cache_root: Optional[str] = None) -> str:
    """The directory of the mix's sequence `which` (its entry in the
    mix's `sequences`: the orbit's start phase and the sensor's seed),
    written unless the cache already holds it. The cache keeps a cell's
    sequences under a fixed directory of the checkout, keyed by the
    generator's sources and the cell's files; a run that writes its
    sequence reads its window slower than one that finds it (section 2
    of PERF.md), so the mix holds few."""
    cache_root = cache_root or os.path.join(c["bench_dir"], "_cache")
    h = hashlib.sha256()
    here = os.path.dirname(os.path.abspath(__file__))
    for name in ("sequence.py", "scene.py", "images.py"):
        with open(os.path.join(here, name), "rb") as f:
            h.update(f.read())
    h.update(json.dumps([c["traffic"], cfg["cam"], cfg["dataset"]],
                        sort_keys=True).encode())
    cell_dir = os.path.join(cache_root, c["name"])
    key = h.hexdigest()[:12]
    final = os.path.join(cell_dir, f"{which}-{key}")
    if os.path.exists(os.path.join(final, "DONE")):
        return final
    if os.path.isdir(cell_dir):  # another generator's or a cut write
        for old in os.listdir(cell_dir):
            if not old.endswith(key):
                shutil.rmtree(os.path.join(cell_dir, old))
    os.makedirs(cell_dir, exist_ok=True)
    part = final + ".part"
    shutil.rmtree(part, ignore_errors=True)
    t = c["traffic"]
    seq = t["sequences"][which]
    write_sequence(cfg["dataset"], part, cfg["cam"], int(t["frames"]),
                   float(t["motion_speed"]), float(seq["phase"]),
                   int(seq["sensor_seed"]), t.get("scene", "v2"),
                   t.get("sensor"), int(t.get("jpeg_quality", 92)), workers)
    with open(os.path.join(part, "DONE"), "w") as f:
        f.write("complete\n")
    _fsync_tree(part)
    os.replace(part, final)
    return final


def _fsync_tree(path: str) -> None:
    """Flush a written recording to disk, so that the kernel's write-back
    of it does not fall into the measured window."""
    for root, dirs, files in os.walk(path):
        for name in files + dirs + ["."]:
            fd = os.open(os.path.join(root, name), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)


# ---------------------------------------------------------------------------
# The probe: spans, counters, captures, the profiled part
# ---------------------------------------------------------------------------

class RecordingDraw:
    """The program's draw object, handing out the same draws and keeping a
    copy of each, in order."""

    def __init__(self, draw):
        self._draw = draw
        self.items: List[torch.Tensor] = []

    def randint(self, shape, lo, hi):
        x = self._draw.randint(shape, lo, hi)
        self.items.append(x.clone())
        return x

    def normal(self, shape):
        x = self._draw.normal(shape)
        self.items.append(x.clone())
        return x

    def __getattr__(self, name):
        return getattr(self._draw, name)


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (list, tuple)):
        return [_clone(v) for v in x]
    return x


class Probe:
    """Spans, counters and captures around one session."""

    def __init__(self, slam, cfg: Dict, config_file: Dict, seconds: float,
                 trace: bool, check_seed: int):
        self.slam, self.cfg, self.widths = slam, cfg, config_file["widths"]
        self.seconds = seconds
        self.trace = trace
        self.spans: List[Dict] = []
        self.window_start = self.window_end = None
        self.first_idx = self.last_idx = None
        self.entry_iters = {"track": 0, "map": 0}  # the cross-check
        self.cur_idx = None
        self.chain = None
        self.cur_span = None
        self.last_knn = None
        self.map_ctx = None
        self.pending = None
        self.records: List[Dict] = []
        self.knn_calls: List = []  # the profiled part's k-NN inputs
        self.prof = None
        self.prof_part = None
        rng = np.random.default_rng(check_seed)
        it = cfg["tracking"]["iters"]
        mi = max(int(cfg["mapping"]["min_iter_ratio"]
                     * cfg["mapping"]["iters"]), 1)
        # the window's tracked frames (by order) and iterations the check
        # compares, and one iteration of its first mapped frame; each with
        # the iteration after it in the same frame
        self.track_pick = {0: int(rng.integers(0, it - 1)),
                           1: int(rng.integers(0, it - 1))}
        self.map_pick = {0: int(rng.integers(0, mi - 1))}
        self.n_track_frames = self.n_map_frames = 0
        self.frame_iter = 0
        self.profile_iters = int(config_file.get("profile_track_iters", 40))
        self._saved = []
        self.paused_s = 0.0

    # ---- installing -----------------------------------------------------
    def install(self):
        from loopy_slam_torch.mapping import mapper as mapper_mod
        from loopy_slam_torch.mapping import tracker as tracker_mod
        from loopy_slam_torch.ops import adam as adam_mod
        from loopy_slam_torch.ops import knn as knn_mod

        def patch(mod, name, fn):
            self._saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn(getattr(mod, name)))

        patch(knn_mod, "query_chunked", self._wrap_knn)
        patch(tracker_mod, "tracking_loss_cached", self._wrap_track_loss)
        patch(mapper_mod, "_map_loss_pool", self._wrap_map_loss)
        patch(mapper_mod, "optimize_map", self._wrap_optimize_map)
        patch(adam_mod, "update", self._wrap_adam)
        slam = self.slam
        self._track_orig, self._map_orig = slam.track_frame, slam.map_frame
        slam.track_frame = self._track_frame
        slam.map_frame = self._map_frame

    def uninstall(self):
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved = []
        for name in ("track_frame", "map_frame"):
            self.slam.__dict__.pop(name, None)
        if self.prof is not None:
            self._stop_profile()

    def clock(self) -> float:
        """The host clock less the profiler's start-up and post-processing,
        which a traced run does inside the window and a user's run never
        does."""
        return time.perf_counter() - self.paused_s

    def _sync(self):
        if self.slam.device.type == "cuda":
            torch.cuda.synchronize(self.slam.device)

    @property
    def in_window(self):
        return self.window_start is not None and self.window_end is None

    # ---- spans around the layers ---------------------------------------
    def _track_frame(self, idx, *a, **kw):
        t0 = self.clock()
        self.cur_span = "track"
        self.cur_idx = idx
        self.frame_iter = 0
        order = self.n_track_frames if self.in_window else None
        profiled = self.trace and order == 0 and self.prof is None
        if profiled:
            self._start_profile()
        try:
            out = self._track_orig(idx, *a, **kw)
        finally:
            self.cur_span = None
        if self.prof is not None:
            self._stop_profile()
        t1 = self.clock()
        if self.in_window:
            self.n_track_frames += 1
        self.spans.append({"name": "track", "idx": idx, "t0": t0, "t1": t1,
                           "window": self.in_window, "profiled": profiled})
        return out

    def _map_frame(self, idx, *a, **kw):
        if idx == self.slam.n_img - 1:
            raise SequenceTooShort(
                f"the sequence ended (frame {idx}) before the window did; "
                "the traffic mix needs more frames")
        t0 = self.clock()
        self.cur_span = "map"
        self.frame_iter = 0
        count0 = self.slam._count_host
        try:
            out = self._map_orig(idx, *a, **kw)
            self._sync()
        finally:
            self.cur_span = None
        t1 = self.clock()
        in_win = self.in_window
        self.spans.append({"name": "map", "idx": idx, "t0": t0, "t1": t1,
                           "window": in_win, "profiled": False,
                           "added": self.slam._count_host - count0})
        if in_win:
            self.n_map_frames += 1
            if t1 - self.window_start >= self.seconds:
                self.window_end, self.last_idx = t1, idx
                raise WindowClosed()
        elif self.window_start is None and idx >= 2:
            # warm-up ends with the first steady mapped frame, which
            # follows frame 0's first mapping and a tracked frame
            self.window_start, self.first_idx = t1, idx + 1
            self.health0 = self.slam.track_health.detach().clone()
        return out

    # ---- the hot calls ---------------------------------------------------
    def _wrap_knn(self, orig):
        def knn_query_chunked(grid, points, queries, k, radius, *a, **kw):
            with self._note("bench.knn"):
                out = orig(grid, points, queries, k, radius, *a, **kw)
            self.last_knn = {"queries": queries, "radius": radius,
                             "D": out[0], "I": out[1], "nn": out[2]}
            if self.prof is not None:
                self.knn_calls.append((grid, queries, k, radius))
            return out
        return knn_query_chunked

    def _count(self, kind: str):
        if self.in_window:
            self.entry_iters["track" if kind == "track" else "map"] += 1

    def _follow(self, kind: str, leaves):
        """The iteration after a captured one: its inputs, which have to be
        what the captured Adam step returned."""
        rec, self.chain = self.chain, None
        if rec is not None:
            rec["chain"] = {"kind": kind, "inputs": _clone(list(leaves))}

    def _wrap_track_loss(self, orig):
        def tracking_loss_cached(cam7, dec, cache, draw, opts, ropts,
                                 exposure=None):
            self._count("track")
            self._follow("track", [cam7])
            order = self.n_track_frames if self.in_window else None
            take = (order in self.track_pick and exposure is None
                    and self.frame_iter == self.track_pick[order])
            self.frame_iter += 1
            if not take:
                with self._note("bench.track.loss"):
                    return orig(cam7, dec, cache, draw, opts, ropts,
                                exposure)
            rd = RecordingDraw(draw)
            with self._note("bench.track.loss"):
                loss, aux = orig(cam7, dec, cache, rd, opts, ropts, exposure)
            self.pending = self._track_record(cam7, dec, cache, rd, opts,
                                              ropts, loss)
            return loss, aux
        return tracking_loss_cached

    def _wrap_map_loss(self, orig):
        def _map_loss_pool(dec, feats, pool, map_pos, draw, stage, opts,
                           ropts, pix_per_frame, exposure=None):
            self._count(stage)
            self._follow("map", [p for p in dec.parameters()] + [feats])
            order = self.n_map_frames if self.in_window else None
            take = (order in self.map_pick and exposure is None
                    and self.frame_iter == self.map_pick[order])
            self.frame_iter += 1
            if not take:
                return orig(dec, feats, pool, map_pos, draw, stage, opts,
                            ropts, pix_per_frame, exposure)
            rd = RecordingDraw(draw)
            loss, aux = orig(dec, feats, pool, map_pos, rd, stage, opts,
                             ropts, pix_per_frame, exposure)
            self.pending = self._map_record(dec, feats, pool, map_pos, rd,
                                            stage, opts, ropts,
                                            pix_per_frame, loss)
            return loss, aux
        return _map_loss_pool

    def _wrap_optimize_map(self, orig):
        def optimize_map(dec, feat, adam_state, dec_mask, feat_mask, *a,
                         **kw):
            self.map_ctx = {"dec_mask": dec_mask, "feat_mask": feat_mask}
            try:
                return orig(dec, feat, adam_state, dec_mask, feat_mask, *a,
                            **kw)
            finally:
                self.map_ctx = None
        return optimize_map

    def _wrap_adam(self, orig):
        def update(params, grads, state, lr, *a, **kw):
            rec, self.pending = self.pending, None
            if rec is not None:
                lrs = list(lr) if isinstance(lr, (list, tuple)) \
                    else [lr] * len(params)
                rec["adam"] = {"params": _clone(params),
                               "grads": _clone(list(grads)),
                               "m": _clone(state.m), "v": _clone(state.v),
                               "step": state.step,
                               "start": _clone(state.start),
                               "lrs": _clone(lrs)}
            with self._note("bench.adam"):
                new, st = orig(params, grads, state, lr, *a, **kw)
            if rec is not None:
                rec["adam"]["new"] = _clone(new)
                self.records.append(rec)
                self.chain = rec
            if self.prof is not None and self.cur_span == "track":
                self.prof_iters += 1
                if self.prof_iters >= self.profile_iters:
                    self._stop_profile()
            return new, st
        return update

    # ---- captures ----------------------------------------------------------
    def _common(self, dec, ropts, draw: RecordingDraw, loss):
        ro = {k: getattr(ropts, k) for k in (
            "radius_query", "nn_num", "min_nn_num", "weighting",
            "encode_rel_pos_in_col", "sigmoid_coef", "n_surface")}
        return {"params": {n: p.detach().clone()
                           for n, p in dec.named_parameters()},
                "ropts": ro, "loss": loss.detach().clone(),
                "noises": draw.items[1:],
                "count": self.slam.map_state.count.detach().clone()}

    def _track_record(self, cam7, dec, cache, rd, opts, ropts, loss):
        S, k = ropts.n_surface, ropts.nn_num
        P = cache["d"].shape[0]
        pick = rd.items[0]
        kn = self.last_knn
        qrows = (pick[:, None] * S + torch.arange(S, device=pick.device)
                 ).reshape(-1)
        I = kn["I"].reshape(P, S * k).index_select(0, pick).reshape(-1, k)
        D = kn["D"].reshape(P, S * k).index_select(0, pick).reshape(-1, k)
        nn = kn["nn"].reshape(P, S).index_select(0, pick).reshape(-1)
        rad = kn["radius"]
        rec = self._common(dec, ropts, rd, loss)
        s = self.slam.map_state
        rec.update(
            kind="track", idx=self.cur_idx, cam7=cam7.detach().clone(),
            i=cache["i"].index_select(0, pick),
            j=cache["j"].index_select(0, pick),
            d=cache["d"].index_select(0, pick),
            c=cache["c"].index_select(0, pick),
            inside=cache["inside"].index_select(0, pick),
            z=cache["z"].index_select(0, pick),
            rq=(None if cache["rq"] is None
                else cache["rq"].index_select(0, pick)),
            I=I.clone(), empty=~(D < 1e9), nn=nn.clone(),
            queries=kn["queries"].index_select(0, qrows).clone(),
            radius=(rad.index_select(0, qrows).clone()
                    if isinstance(rad, torch.Tensor) and rad.dim() == 1
                    else float(rad)),
            feats=s.feat.detach().clone(), pos=s.pos.detach().clone(),
            opts={k: getattr(opts, k) for k in (
                "fx", "fy", "cx", "cy", "handle_dynamic", "w_color_loss",
                "use_color_in_tracking")})
        return rec

    def _map_record(self, dec, feats, pool, map_pos, rd, stage, opts, ropts,
                    pix, loss):
        F, P = pool.d.shape
        S, k = ropts.n_surface, ropts.nn_num
        idx = rd.items[0]
        flat = (torch.arange(F, device=idx.device)[:, None] * P
                + idx).reshape(-1)

        def take(a):
            return a.reshape((F * P,) + a.shape[2:]).index_select(0, flat)

        D = take(pool.D).reshape(-1, k)
        rq = None if pool.rq is None else take(pool.rq)
        rec = self._common(dec, ropts, rd, loss)
        ctx = self.map_ctx
        rec.update(
            kind="map", stage=stage, d=take(pool.d), c=take(pool.c),
            valid=take(pool.valid), z=take(pool.z_vals), pts=take(pool.pts),
            I=take(pool.I).reshape(-1, k).clone(), empty=~(D < 1e9),
            nn=take(pool.nn).reshape(-1).clone(), rq=rq,
            queries=take(pool.pts).reshape(-1, 3).clone(),
            radius=(rq.repeat_interleave(S) if rq is not None
                    else float(ropts.radius_query)),
            feats=feats.detach().clone(), pos=map_pos.detach().clone(),
            dec_on=dict(ctx["dec_mask"]),
            feat_mask=ctx["feat_mask"].detach().clone(),
            opts={"w_color_loss": opts.w_color_loss})
        return rec

    # ---- the profiled part -------------------------------------------------
    def _note(self, name: str):
        """A named range in the profiled part's trace (else nothing)."""
        import contextlib

        if self.prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.slam.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        t0 = time.perf_counter()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.prof_iters = 0
        self.prof_t0 = time.perf_counter()
        self.paused_s += self.prof_t0 - t0
        self.prof_cost = {"start_s": self.prof_t0 - t0}

    def _stop_profile(self):
        self._sync()
        t1 = time.perf_counter()
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        self.paused_s += time.perf_counter() - t1
        self.prof_cost["stop_s"] = time.perf_counter() - t1
        self.prof_part = {"prof": prof, "wall_s": t1 - self.prof_t0,
                          "cost": self.prof_cost,
                          "iters": self.prof_iters,
                          "knn": list(self.knn_calls)}
        self.knn_calls = []


# ---------------------------------------------------------------------------
# Reading the run
# ---------------------------------------------------------------------------

def map_schedule(cfg: Dict, added_points: int) -> Dict[str, int]:
    """A steady mapped frame's iterations by stage, from the configuration's
    schedule and the points the frame added (the program's count grows by
    N_add points a location)."""
    m = cfg["mapping"]
    locations = added_points / int(cfg["pointcloud"]["N_add"])
    num = m["iters"]
    num = int(np.clip(num * locations / 300, int(m["min_iter_ratio"] * num),
                      2 * num))
    n_geo = min(int(num * m["geo_iter_ratio"]) + 1, num)
    return {"geometry": n_geo, "color": num - n_geo}


def window_work(cfg: Dict, widths: Dict, n_img: int, spans: List[Dict]):
    """(tracking iterations, mapping iterations, model FLOPs) of the given
    spans, from the configuration alone: a tracked frame runs
    tracking.iters iterations of tracking.pixels rays, a mapped frame its
    schedule over a window of mapping_window_size frames (twice that past
    4000 frames) of pixels // window rays each."""
    t, m = cfg["tracking"], cfg["mapping"]
    ws = m["mapping_window_size"] * (2 if n_img > 4000 else 1)
    rays = ws * max(m["pixels"] // ws, 1)
    n_track = n_map = flop = 0
    for s in spans:
        if s["name"] == "track":
            n_track += t["iters"]
            flop += t["iters"] * iteration_flops("track", t["pixels"],
                                                 widths, cfg)
        else:
            for stage, n in map_schedule(cfg, s["added"]).items():
                n_map += n
                flop += n * iteration_flops(stage, rays, widths, cfg)
    return n_track, n_map, flop


class Run:
    """What the metric readers read: the window's frames and spans, the
    program's own per-frame timings, the counts, the profiled part. The
    per-iteration times, the host's share and the FLOP rate leave out the
    span that the profiler ran in (`timed_s` is the window without it)."""

    def __init__(self, probe: Probe, setup_s: float, trace_summary):
        p = probe
        self.setup_s = setup_s
        self.window_s = p.window_end - p.window_start
        self.first_idx, self.last_idx = p.first_idx, p.last_idx
        ends: Dict[int, float] = {}
        self.track_s = self.map_s = 0.0
        self.profiled_idx = set()
        self.timed_s = self.window_s
        timed = []
        for s in p.spans:
            if s["window"]:
                ends[s["idx"]] = max(ends.get(s["idx"], 0.0), s["t1"])
                if s["profiled"]:
                    self.profiled_idx.add(s["idx"])
                    self.timed_s -= s["t1"] - s["t0"]
                    continue
                timed.append(s)
                if s["name"] == "track":
                    self.track_s += s["t1"] - s["t0"]
                else:
                    self.map_s += s["t1"] - s["t0"]
        idxs = list(range(p.first_idx, p.last_idx + 1))
        missing = [i for i in idxs if i not in ends]
        if missing:
            raise RuntimeError(f"window frames without a span: {missing}")
        prev, self.frame_s = p.window_start, []
        for i in idxs:
            self.frame_s.append(ends[i] - prev)
            prev = ends[i]
        self.frames = len(idxs)
        self.frame_idx = idxs
        self.in_frame_s = {i: 0.0 for i in idxs}
        for s in p.spans:
            if s["window"]:
                self.in_frame_s[s["idx"]] += s["t1"] - s["t0"]
        data = probe.slam.timings.get("data", [])
        self.data_s = [data[i] for i in idxs if i < len(data)]
        self.track_iters, self.map_iters, self.flops = window_work(
            p.cfg, p.widths, p.slam.n_img, timed)
        self.all_iters = window_work(p.cfg, p.widths, p.slam.n_img,
                                     [s for s in p.spans if s["window"]])
        self.entry_iters = dict(p.entry_iters)
        self.peak_flops = PEAK_F32_FLOPS
        self.trace = trace_summary


def summarize_trace(part, device_type: str, tmpdir: str) -> Optional[Dict]:
    """The profiled part's device time: busy seconds (the union of the
    device operations), the device operations by total time, the idle gaps
    by the benchmark's span that the host was in, the select kernel's
    time, and the k-NN bound of the calls captured in the part."""
    if part is None:
        return None
    path = os.path.join(tmpdir, "trace.json")
    part["prof"].export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    os.remove(path)
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                 for e in events if e.get("ph") == "X" and e.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    notes = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"])
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("bench.")]
    by_op: Dict[str, float] = {}
    for t0, t1, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (t1 - t0) * 1e-6
    busy, gaps, cur0, cur1 = 0.0, [], None, None
    for t0, t1, _ in dev:
        if cur1 is None or t0 > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
                gaps.append((cur1, t0))
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    if cur1 is not None:
        busy += cur1 - cur0
    by_gap: Dict[str, float] = {}
    for g0, g1 in gaps:
        inside = [n for n in notes if n[0] <= g0 < n[1]]
        name = (min(inside, key=lambda n: n[1] - n[0])[2] if inside
                else "bench.track.frame: backward, pool, host")
        by_gap[name] = by_gap.get(name, 0.0) + (g1 - g0) * 1e-6
    knn_s = sum(v for k, v in by_op.items() if "knn_select" in k)
    bound = 0.0
    for grid, queries, k, radius in part["knn"]:
        per_q = isinstance(radius, torch.Tensor) and radius.dim() == 1
        nbytes, fl = knn_query_cost(grid.cell_data, grid.cell_size,
                                    grid.cell_fill, queries, k, per_q)
        bound += knn_bound_s(nbytes, fl)
    return {"events": len(events), "busy_s": busy * 1e-6 if dev else 0.0,
            "window_s": part["wall_s"], "iters": part["iters"],
            "device_ops": sorted(by_op.items(), key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(by_gap.items(), key=lambda x: -x[1])[:10],
            "knn_kernel_s": knn_s, "knn_bound_s": bound,
            "knn_calls": len(part["knn"]), "device": device_type,
            "cost": part["cost"]}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             spec_path: Optional[str] = None,
             cfg_overrides: Optional[Dict] = None, control: bool = False,
             workers: Optional[int] = None,
             cache_root: Optional[str] = None,
             limits: Optional[Dict] = None, log=sys.stderr) -> Dict:
    """Run the cell and return the result line's object (with "checks").
    t_start: the process's start on the host clock (setup_s counts from
    it). device "cpu", cfg_overrides, workers, cache_root and limits (over
    the configuration's) serve the CPU tests at tiny sizes; control also
    reads the control's numbers beside the program's."""
    c = load_cell(name, spec_path)
    if limits:
        c["config"]["limits"] = dict(c["config"]["limits"], **limits)
    cfg = copy.deepcopy(c["config"]["resolved"])
    if cfg_overrides:
        update_recursive(cfg, cfg_overrides)
    sd = seeds(seed, len(c["traffic"]["sequences"]))
    workers = workers or max(1, min((os.cpu_count() or 2) - 1, 7))
    check_mod.verify_assets(c["config"], REPO_DIR)
    seq = prepare_sequence(c, cfg, sd["sequence"], workers, cache_root)
    tmp = tempfile.mkdtemp(prefix="loopy_bench_")
    try:
        cfg["data"]["input_folder"] = seq
        cfg["data"]["output"] = os.path.join(tmp, "out")
        cfg["setup_seed"] = sd["program"]
        pre = cfg.get("pretrained_decoders", {}).get("middle_fine")
        if pre:
            cfg["pretrained_decoders"]["middle_fine"] = os.path.join(
                REPO_DIR, pre)
        return _session(c, cfg, sd, seconds, trace, t_start, device, tmp,
                        control, log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _session(c, cfg, sd, seconds, trace, t_start, device, tmp, control,
             log):
    import contextlib

    from loopy_slam_torch.slam import LoopySLAM

    with contextlib.redirect_stdout(log):
        slam = LoopySLAM(cfg, device=device)
        probe = Probe(slam, cfg, c["config"], seconds, trace, sd["check"])
        probe.install()
        try:
            slam.run()
            raise RuntimeError("the program's loop ended before the window")
        except WindowClosed:
            pass
        finally:
            probe.uninstall()
            slam.close()
    setup_s = probe.window_start - t_start
    mem = (torch.cuda.max_memory_allocated(slam.device)
           if slam.device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise check_mod.ForbiddenImport(found)
    summary = summarize_trace(probe.prof_part, slam.device.type, tmp) \
        if trace else None
    run = Run(probe, setup_s, summary)
    recording = ref_frames.Recording(cfg["dataset"], cfg["cam"],
                                     c["traffic"], sd["sequence"])
    idxs = range(run.first_idx, run.last_idx + 1)
    est, gt = slam.estimate_c2w[list(idxs)], slam.gt_c2w[list(idxs)]
    health = slam.track_health.cpu().numpy()
    rejects = int(health[1] - float(probe.health0[1]))
    failed = int(sum(not np.isfinite(est[i]).all()
                     for i in range(len(est)))) + rejects
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    ate = float(np.sqrt(np.mean(err ** 2))) if len(err) else float("nan")
    n_points = int(slam._count_host)
    segments = len(slam.fm.fragments)
    records, slam_dev = probe.records, slam.device
    del slam, probe
    if slam_dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = check_mod.compare(records, c["config"]["limits"], recording,
                               control=control)
    metrics = {}
    group = "per_layer" if trace else "end_to_end"
    for m in c["metrics"]:
        if m["group"] != group:
            continue
        v = read_metric(m["reader"], run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    print(f"window: frames {run.first_idx}..{run.last_idx} ({run.frames}) "
          f"in {run.window_s!r} s, {len(run.frame_s)} frame_s samples, "
          f"track iters {run.all_iters[0]}, map iters {run.all_iters[1]} "
          f"by the schedule ({run.entry_iters['track']} and "
          f"{run.entry_iters['map']} at the entry points)", file=log)
    print("frame_s: " + " ".join(f"{i}:{f:.3f}" for i, f in
                                 zip(run.frame_idx, run.frame_s)), file=log)
    print(f"session: ate_rmse_m {ate!r} over the window, health rejects "
          f"{rejects} in the window ({int(health[1])} in all), points "
          f"{n_points}, segments {segments}, setup_s {setup_s!r}", file=log)
    if summary is not None:
        print(f"profiled part: {summary['iters']} tracking iterations of "
              f"the window's first tracked frame, {summary['events']} "
              f"trace events, busy {summary['busy_s']!r} s of "
              f"{summary['window_s']!r} s, knn calls "
              f"{summary['knn_calls']}; the profiler's start "
              f"{summary['cost']['start_s']!r} s and stop "
              f"{summary['cost']['stop_s']!r} s left out of the window",
              file=log)
    out = {"correct": all(ch["ok"] for ch in checks.values())
           and failed == 0,
           "attempted": run.frames, "failed": failed, "metrics": metrics,
           "device": device_info(slam_dev, mem)}
    if summary is not None:
        out["device"]["busy_s"] = summary["busy_s"]
        out["device"]["window_s"] = summary["window_s"]
        out["breakdown"] = {
            "device_ops": [[k, v] for k, v in summary["device_ops"]],
            "idle_gaps": [[k, v] for k, v in summary["idle_gaps"]]}
    out["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                     for k, v in checks.items()}
    if control:
        out["control"] = {k: v.get("control") for k, v in checks.items()}
    for k, v in checks.items():  # the last lines of standard error
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}"
              + (f" control {v['control']!r}" if control else ""), file=log)
    return out


def device_info(dev, mem: int) -> Dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(mem),
            "power_limit": power_limit()}


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it (a card set below
    700 W runs slower under load), or "unknown"."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"

