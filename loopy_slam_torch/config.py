"""YAML config system with recursive inheritance.

The port's own copy of the JAX package's config surface: the same
`DEFAULTS`, the same `inherit_from` chain (scene -> dataset -> base, child
values recursively override parent dicts). The YAML files are read by
`parse_yaml` below, the port's own reader of the subset the repo's configs
use, on every machine: the card's machine has no PyYAML.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Defaults: the full knob surface of the reference base config. Kept equal
# to the JAX package's DEFAULTS (a parity test holds them equal), including
# keys the port ignores such as "device".
# ---------------------------------------------------------------------------
DEFAULTS: Dict[str, Any] = {
    "verbose": True,
    "low_gpu_mem": True,          # accepted for config parity; unused
    "use_view_direction": False,
    "use_dynamic_radius": True,
    "wandb": False,
    "wandb_folder": "output",
    "project_name": "loopy_slam_tpu",
    "setup_seed": 1219,
    "orbvoc": "",
    "stop": 0,
    "dataset": "synthetic",
    "device": "tpu",              # the JAX package's platform hint; unused
    "model": {
        "c_dim": 32,
        "exposure_dim": 8,
        # bf16 MLP-trunk matmuls with f32 accumulation (TPU perf; Fourier
        # phases stay f32). Applied process-wide at session construction.
        "bf16_trunks": True,
        "pos_embedding_method": "fourier",
        "encode_rel_pos_in_col": True,
        "encode_exposure": False,
        "encode_viewd": True,
    },
    "pretrained_decoders": {
        # npz produced by tools/import_pretrained.py from the reference's
        # middle_fine.pt (reference src/Point_SLAM.py:177-198). Empty => train
        # geometry decoder from random init.
        "middle_fine": "",
    },
    "tracking": {
        # loop-closure edge-filter knobs (reference configs/point_slam.yaml:20-39)
        "global_iter": 10000000,
        "global_reg_conf": 0.99999,
        "distance_thresholding": False,
        "iter_std_thresh": 0.15,
        "gt_constraints": False,
        "filter": True,
        "gt_filtering": False,
        "gt_thresh": 0.01,
        "old_trans_mag_filter": True,
        "newnew_trans_mag_filter": False,
        "fitness_thresh": 0.1,
        "trans_mag_percentile": 90,
        "std_threshold": 0.04,
        "norm_trans_mag_thresh": 0.30,
        "prune_pgo": 0.25,
        "lc_pref": 5,
        "mult_dbow": 1.0,
        "dbow_filter": True,
        "min_dist": 1,
        "kval": 2,
        "visual_odometer": False,
        # pose optimization knobs (reference configs/point_slam.yaml:41-57)
        "ignore_edge_W": 20,
        "ignore_edge_H": 20,
        "use_color_in_tracking": True,
        "handle_dynamic": True,
        "depth_limit": False,
        "vis_freq": 50,
        "vis_inside": False,
        "vis_inside_freq": 50,
        "w_color_loss": 0.5,
        "separate_LR": True,
        "const_speed_assumption": True,
        "sample_with_color_grad": False,
        "gt_camera": False,
        "lr": 0.002,
        "pixels": 200,
        "iters": 20,
        # TPU perf: refresh the k-NN (and the gathered neighbor features)
        # every N pose iterations instead of every iteration — the pose
        # moves sub-mm per Adam step, so neighbor sets are near-invariant
        # within a block. Each block queries a pool_factor*pixels ray POOL
        # so every iteration still draws a fresh pixel batch from it
        # (freezing one batch per block cost 7x bench ATE in round 2).
        # knn_refresh=0 disables (reference-exact per-iter query). Blocks
        # follow a warmup schedule (2, 4, 8, refresh, ...): the first
        # cache is built at the motion-model pose where staleness is
        # worst. Measured r3 bench trade (BASELINE.md): exact 0.00131 m
        # ATE @ 1.21 fps vs pooled 0.00172 m @ 1.74 fps.
        "knn_refresh": 10,
        "pool_factor": 4,
        # failure containment: reject a frame's pose update (keep the
        # motion-model pose) when its best per-masked-pixel tracking loss
        # exceeds health_gate_factor * EMA over healthy frames. Catches
        # tracking-lock loss in degenerate stretches (planar views,
        # texture aliases) where the optimizer converges to a wrong but
        # photometrically stable pose; the EMA freezes on rejected frames
        # so runaway loss cannot widen its own gate. 0 disables.
        "health_gate_factor": 4.0,
        # EMA freeze threshold: frames above health_ema_freeze x EMA are
        # still ACCEPTED (pose moves) but do not update the EMA, so a
        # gradual loss creep cannot drag the reject threshold up with it
        # (r4 flagship replay: healthy frames < 1.35x, a real slide
        # 1.7-4x; at the old follow-everything EMA the 36 cm slide drew
        # ZERO rejects). 4.0/1.5 first-rejects the replayed slide at
        # frame 1840 with 0 false positives over 1790 healthy frames.
        "health_ema_freeze": 1.5,
        # reject-streak escape hatch: after this many CONSECUTIVE
        # loss-rejects with healthy ray support, accept the optimized
        # pose and re-seed the EMA at the current frame's loss level — a
        # legitimate sustained loss shift (poorly-mapped area, exposure
        # change) must not pin tracking to the motion model forever
        # against a stale frozen baseline. Support-collapse rejects
        # never escape. 0 disables the hatch.
        "health_reject_streak": 10,
    },
    "mapping": {
        "filter_before_add_points": True,
        "color_refine": True,
        "geo_iter_ratio": 0.4,
        "geo_iter_first": 400,
        "every_frame": 5,
        "BA": False,
        "BA_cam_lr": 0.0002,
        "frustum_edge": -4,
        "fix_geo_decoder": True,
        "fix_color_decoder": False,
        "vis_freq": 50,
        "vis_inside": False,
        "vis_inside_freq": 1000,
        "ckpt_freq": 10000,
        "save_ckpts": True,
        "keyframe_every": 50,
        "keyframe_global_every": 20,
        "fixed_segment_size": 50,
        "segment_strategy": "rot_trans",
        "segment_rot_cos": 0.94,
        "segment_rel_trans": 0.30,
        "mapping_window_size": 5,
        "w_color_loss": 0.1,
        "frustum_feature_selection": True,
        "keyframe_selection_method": "overlap",
        "save_selected_keyframes_info": True,
        "pixels": 1000,
        "pixels_adding": 6000,
        "pixels_based_on_color_grad": 0,
        "iters_first": 1500,
        "iters": 400,
        "save_rendered_image": True,
        "min_iter_ratio": 0.95,
        # TPU perf: precompute k-NN once per optimizer chunk over a pool of
        # pixel_pool_factor * pixels rays, then subsample per iteration
        # (the map and poses are fixed across a mapping frame, so neighbor
        # sets are loop-invariant). 0 disables (reference-exact resampling).
        # device_chunk_iters bounds one device program AND sets the pool
        # refresh cadence: at 250 each pool ray was reused ~31x and bench
        # no-align ATE degraded 4x (r2); at 64 the pool is accuracy-
        # neutral (BASELINE.md r3 ablations) and still amortizes the
        # query to ~1/8 of an exact iteration.
        "pixel_pool_factor": 8,
        "device_chunk_iters": 64,
        # (removed lever, negative result — BASELINE.md "round-4 A/B":
        # ray-coherent neighbor dedup (pool_unique) shrank the hot gather
        # 2.5x but bought only ~3% map time — the gather is not the
        # bottleneck at this batch size — while its U-nearest truncation
        # cost 1.5x bench ATE. Deleted like the fused-MLP kernel was.)
        "init": {
            "geometry": {"decoders_lr": 0.001, "geometry_lr": 0.03, "color_lr": 0.0},
            "color": {"decoders_lr": 0.005, "geometry_lr": 0.005, "color_lr": 0.005},
        },
        "stage": {
            "geometry": {"decoders_lr": 0.001, "geometry_lr": 0.03, "color_lr": 0.0},
            "color": {"decoders_lr": 0.005, "geometry_lr": 0.005, "color_lr": 0.005},
        },
    },
    "cam": {
        "H": 680, "W": 1200,
        "fx": 600.0, "fy": 600.0, "cx": 599.5, "cy": 339.5,
        "png_depth_scale": 6553.5,
        "crop_edge": 0,
    },
    "rendering": {
        "N_surface": 5,
        "near_end": 0.3,
        "near_end_surface": 0.98,
        "far_end_surface": 1.02,
        "sigmoid_coef_tracker": 0.1,
        "sigmoid_coef_mapper": 0.1,
        "sample_near_pcl": True,
        "skip_zero_depth_pixel": False,
        "eval_img": False,
        # optional LPIPS-alex weight bundle (utils/lpips.py); None -> the
        # lpips metric is reported as None (no egress to fetch weights)
        # LPIPS weight bundle. The shipped default is the severity-
        # calibrated RANDOM-FEATURE bundle (scripts/make_lpips_randfeat.py)
        # because the official BAPPS/ImageNet calibration cannot be staged
        # offline — values are comparable across runs of this framework,
        # NOT to published LPIPS numbers (see BASELINE.md). Point this at a
        # scripts/convert_lpips_weights.py bundle for the official metric.
        "lpips_weights": "pretrained/lpips_alex_randfeat.npz",
    },
    "data": {"dim": 3, "input_folder": "", "output": "output/run"},
    # multi-chip execution (TPU-native addition): rays data-parallel over a
    # device mesh with psummed gradients. 0/1 = single device.
    # rays data-parallel over a replicated map (n_devices), or the map
    # itself cell-sharded across the mesh with ring-collective k-NN
    # (map_shard; capacity scaling — parallel/map_shard.py)
    "parallel": {"n_devices": 0, "map_shard": False},
    "meshing": {"eval_rec": True, "mesh_freq": -1},
    "pointcloud": {
        "nn_num": 8,
        "min_nn_num": 2,
        "N_add": 3,
        "nn_weighting": "distance",
        "radius_add": 0.04,
        "radius_min": 0.02,
        "radius_query": 0.08,
        "radius_mesh": 0.08,
        "radius_add_max": 0.08,
        "radius_add_min": 0.02,
        "radius_query_ratio": 2,
        "color_grad_threshold": 0.15,
        "near_end_surface": 0.98,
        "far_end_surface": 1.02,
        "nlist": 400,       # accepted for parity; the hash grid has no IVF lists
        "nprobe": 4,
        "fix_interval_when_add_along_ray": False,
        # TPU-native additions (static-shape capacity planning):
        "capacity": 2 ** 19,          # max points in the global buffer
        "cell_table_size": 2 ** 17,   # spatial-hash table size
        "max_per_cell": 32,           # candidate slots per hash-cell row.
                                      # 32 slots = one full 128-lane VPU
                                      # row of (x,y,z,idx) groups. Density
                                      # is capped here by construction:
                                      # add_points skips locations whose
                                      # hash row is full (a point an
                                      # overflowed row cannot index would
                                      # be invisible to every query);
                                      # residual n_dropped comes only
                                      # from hash-merged cells
    },
}


def update_recursive(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Recursively merge `src` into `dst` (child overrides parent)."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            update_recursive(dst[k], v)
        else:
            dst[k] = v


class YAMLError(ValueError):
    """A YAML construct outside the subset parse_yaml reads."""


# plain scalars, resolved as YAML 1.1 (PyYAML's safe_load) resolves them;
# one extension: an exponent without a dot (1e-3) is a float here (YAML
# 1.2's reading), where PyYAML would return the string "1e-3"
_NULLS = {"~", "null", "Null", "NULL"}
_BOOLS = {v: b for b, vs in ((True, "yes Yes YES true True TRUE on On ON"),
                             (False, "no No NO false False FALSE off Off OFF"))
          for v in vs.split()}
_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+]?[0-9]+)?$"
                    r"|[-+]?[0-9]+[eE][-+]?[0-9]+$")
# other typed forms of YAML 1.1 (octal, hex, 1_000, sexagesimal, dates,
# .inf): refused rather than read as strings
_NUMBERISH = re.compile(r"[-+]?\.?[0-9]|[-+]?\.(inf|nan)$|- ", re.I)


def _plain(text: str, where: str):
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if _NUMBERISH.match(text) or text[0] in "&*!|>%@`{}[],?" or text == "-":
        raise YAMLError(f"{where}: unsupported YAML scalar {text!r}")
    return text


def _opens_quote(s: str, i: int) -> bool:
    """A quote at s[i] starts a quoted scalar (not an apostrophe inside a
    plain one)."""
    return s[i] in "'\"" and (i == 0 or s[i - 1] in " [{,:")


def _strip_comment(line: str) -> str:
    """The line without its comment (a '#' at its start or after a blank,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif _opens_quote(line, i):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


class _Flow:
    """Recursive-descent reader of one flow value: [a, b], {k: v}, quoted
    or plain scalars, nested."""

    def __init__(self, text: str, where: str):
        self.s, self.i, self.where = text, 0, where

    def fail(self, msg):
        raise YAMLError(f"{self.where}: {msg} in {self.s!r}")

    def peek(self):
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1
        return self.s[self.i] if self.i < len(self.s) else ""

    def expect(self, ch):
        if self.peek() != ch:
            self.fail(f"expected {ch!r} at column {self.i + 1}")
        self.i += 1

    def value(self, in_flow: bool):
        c = self.peek()
        if c == "[":
            return self.seq()
        if c == "{":
            return self.mapping()
        if c in "'\"":
            return self.quoted()
        start = self.i
        while self.i < len(self.s):
            ch = self.s[self.i]
            if in_flow and ch in ",]}":
                break
            if ch == ":" and (self.i + 1 == len(self.s)
                              or self.s[self.i + 1] in " ,]}"):
                break
            self.i += 1
        text = self.s[start:self.i].strip()
        if not text:
            return None
        return _plain(text, self.where)

    def quoted(self):
        q = self.s[self.i]
        self.i += 1
        out = []
        while self.i < len(self.s):
            ch = self.s[self.i]
            self.i += 1
            if ch == q:
                if q == "'" and self.s[self.i:self.i + 1] == "'":
                    out.append("'")
                    self.i += 1
                    continue
                return "".join(out)
            if ch == "\\" and q == '"':
                esc = self.s[self.i:self.i + 1]
                self.i += 1
                if esc not in _ESCAPES:
                    self.fail(f"unsupported escape \\{esc}")
                out.append(_ESCAPES[esc])
                continue
            out.append(ch)
        self.fail("unterminated quoted string")

    def seq(self):
        self.expect("[")
        out: List[Any] = []
        if self.peek() == "]":
            self.i += 1
            return out
        while True:
            out.append(self.value(in_flow=True))
            c = self.peek()
            self.i += 1
            if c == "]":
                return out
            if c != ",":
                self.fail("expected ',' or ']'")

    def mapping(self):
        self.expect("{")
        out: Dict[Any, Any] = {}
        if self.peek() == "}":
            self.i += 1
            return out
        while True:
            key = self.value(in_flow=True)
            self.expect(":")
            out[key] = self.value(in_flow=True)
            c = self.peek()
            self.i += 1
            if c == "}":
                return out
            if c != ",":
                self.fail("expected ',' or '}'")

    def whole(self, in_flow: bool):
        v = self.value(in_flow)
        if self.peek():
            self.fail(f"unexpected text at column {self.i + 1}")
        return v


_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "r": "\r",
            "/": "/", "0": "\0"}


def _logical_lines(text: str, path: str) -> List[Tuple[int, int, str]]:
    """(line number, indent, content) per non-blank line, comments cut, a
    flow value spread over several lines joined into its first."""
    out: List[Tuple[int, int, str]] = []
    pending = None  # [lineno, indent, text, open brackets]
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw)
        if pending is not None:
            pending[2] += " " + line.strip()
        elif not line.strip():
            continue
        else:
            body = line.lstrip(" ")
            if body.startswith("\t") or "\t" in line[:len(line) - len(body)]:
                raise YAMLError(f"{path}:{n}: tab in indentation")
            if body in ("---", "...") or body.startswith(("- ", "%")) \
                    or body == "-":
                raise YAMLError(f"{path}:{n}: unsupported YAML line "
                                f"{body!r} (block sequences, documents and "
                                "directives are not read)")
            pending = [n, len(line) - len(body), body]
        depth, quote = 0, None
        for i, ch in enumerate(pending[2]):
            if quote:
                quote = None if ch == quote else quote
            elif _opens_quote(pending[2], i):
                quote = ch
            elif ch in "[{":
                depth += 1
            elif ch in "]}":
                depth -= 1
        if depth <= 0:
            out.append(tuple(pending))
            pending = None
    if pending is not None:
        raise YAMLError(f"{path}:{pending[0]}: unclosed flow collection")
    return out


def _split_key(body: str, where: str) -> Tuple[Any, str]:
    """'key: value' -> (key, value text); the key plain or quoted."""
    f = _Flow(body, where)
    if body[0] in "[{?":
        raise YAMLError(f"{where}: unsupported mapping key in {body!r}")
    key = f.quoted() if body[0] in "'\"" else None
    if key is None:
        m = re.search(r":( |$)", body)
        if m is None:
            raise YAMLError(f"{where}: expected 'key: value', got {body!r}")
        key = _plain(body[:m.start()].strip(), where)
        return key, body[m.end():].strip()
    rest = body[f.i:].lstrip(" ")
    if not rest.startswith(":"):
        raise YAMLError(f"{where}: expected ':' after the key in {body!r}")
    return key, rest[1:].strip()


def parse_yaml(text: str, path: str = "<string>") -> Any:
    """The subset of YAML the repo's configs use: nested block mappings,
    flow lists and mappings ([a, b], {k: v}, also over several lines),
    ints, floats (1.5, 1000., 1e-3), bools, null/~, quoted and plain
    strings, and comments. Anything else (block sequences, anchors, tags,
    block scalars, several documents, other number forms) raises YAMLError
    naming the file and the line. Equal to yaml.safe_load on that subset,
    except that 1e-3 is a float (PyYAML reads a string)."""
    lines = _logical_lines(text, path)
    if not lines:
        return None
    if lines[0][2][0] in "[{":
        if len(lines) > 1:
            raise YAMLError(f"{path}:{lines[1][0]}: text after the document")
        return _Flow(lines[0][2], f"{path}:{lines[0][0]}").whole(False)

    def block(i: int, indent: int) -> Tuple[Dict[Any, Any], int]:
        out: Dict[Any, Any] = {}
        while i < len(lines):
            n, ind, body = lines[i]
            where = f"{path}:{n}"
            if ind < indent:
                break
            if ind > indent:
                raise YAMLError(f"{where}: unexpected indentation")
            key, rest = _split_key(body, where)
            i += 1
            if rest:
                if rest[0] in "&*!|>":
                    raise YAMLError(f"{where}: unsupported YAML value "
                                    f"{rest!r}")
                out[key] = _Flow(rest, where).whole(in_flow=False)
            elif i < len(lines) and lines[i][1] > indent:
                out[key], i = block(i, lines[i][1])
            else:
                out[key] = None
        return out, i

    doc, i = block(0, lines[0][1])
    if i < len(lines):
        raise YAMLError(f"{path}:{lines[i][0]}: unexpected indentation")
    return doc


def read_yaml(path: str) -> Any:
    """parse_yaml of a file."""
    with open(path, "r") as f:
        return parse_yaml(f.read(), path)


def load_config(path: str, default_path: Optional[str] = None) -> Dict[str, Any]:
    """Load a YAML config, resolving the recursive `inherit_from` chain on
    top of DEFAULTS."""
    cfg = copy.deepcopy(DEFAULTS)
    if default_path is not None and os.path.exists(default_path):
        update_recursive(cfg, read_yaml(default_path) or {})
    chain = []
    cur: Optional[str] = path
    seen = set()
    while cur:
        if cur in seen:
            raise ValueError(f"inherit_from cycle at {cur}")
        seen.add(cur)
        node = read_yaml(cur) or {}
        chain.append(node)
        cur = node.get("inherit_from")
    for node in reversed(chain):
        update_recursive(cfg, node)
    cfg.pop("inherit_from", None)
    _reject_removed_keys(cfg)
    return cfg


# knobs removed after a losing A/B in the JAX package: a stale YAML that
# still sets one fails loudly instead of being silently ignored
_REMOVED_KEYS = {
    ("mapping", "pool_unique"):
        "removed (ray-coherent neighbor dedup cost 1.5x ATE for ~3% speed)",
}


def _reject_removed_keys(cfg: Dict[str, Any]) -> None:
    for (group, key), why in _REMOVED_KEYS.items():
        if isinstance(cfg.get(group), dict) and key in cfg[group]:
            raise ValueError(
                f"config key {group}.{key} was removed: {why}. "
                f"Delete it from the YAML.")
