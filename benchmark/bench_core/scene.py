"""The procedural room the traffic is rendered from: a frozen copy of
`loopy_slam_torch/utils/datasets.Synthetic`'s geometry, texture and orbit,
so that a later change to the program's own scene cannot change the
benchmark's inputs. `tests/test_bench_frozen_inputs.py` holds it equal to
the program's copy. The one addition is the orbit's start phase: frame i
sits at orbit position `phase + i * motion_speed` (the program's copy
starts every sequence at phase 0).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class Scene:
    """Analytic RGBD of a furnished, textured box room, seen by a pinhole
    camera `cam` (H, W, fx, fy, cx, cy) moving along the room's orbit."""

    # interior objects, all ≥0.5 m clear of the camera-path envelope
    # (|x|≤0.45, |y|≤0.10, z∈[-0.50, 0.10] for the default orbit):
    # axis-aligned boxes as (lo_xyz, hi_xyz) rows...
    _BOXES = np.array([
        [1.05, -1.50, -0.90, 1.75, -0.20, 0.30],    # cabinet on +x wall
        [-1.75, -1.50, 0.50, -1.05, -0.65, 1.40],   # table in -x/+z corner
        [-0.90, -0.15, -1.98, 0.20, 0.90, -1.50],   # shelf on -z wall
        [0.50, 0.75, -1.95, 1.90, 1.50, -0.85],     # soffit +x/-z ceiling
        [-0.50, -1.50, 1.10, 0.50, -0.75, 1.80],    # chest on +z wall
    ])
    # ...and spheres as (center_xyz, radius) rows
    _SPHERES = np.array([
        [0.80, -1.08, 1.35, 0.42],
        [-1.45, 0.85, -1.25, 0.35],
    ])
    # per-surface color multipliers: row 0 = walls, then boxes, then spheres
    _TINTS = np.array([
        [1.00, 1.00, 1.00],
        [1.00, 0.72, 0.62],
        [0.68, 1.00, 0.74],
        [0.70, 0.80, 1.00],
        [1.00, 0.95, 0.58],
        [0.85, 0.68, 1.00],
        [0.62, 0.95, 1.00],
        [1.00, 0.70, 0.88],
    ])

    # Scene v3 (data.scene: "v3"): the r4 v2 flagship run still slid
    # 36 cm in its final 200 frames — views at t in [0.8, 1.0] of the
    # orbit face the +z wall with only 3-6% object pixels (the v2
    # furniture sits outside that view cone), leaving near-planar
    # geometry whose only anti-alias signal was the weak 0.125-amplitude
    # ramp (BASELINE.md round-4 post-mortem). v3 mounts structure on all
    # four walls AT CAMERA HEIGHT (y in [-0.3, 0.9]) plus mid-room
    # columns/beams so every orbit view cone contains real depth
    # variation, and strengthens the unique texture components. All
    # additions keep >= 0.5 m clearance of the camera-path envelope.
    _BOXES_V3 = np.array([
        [-1.70, -0.10, 1.70, -0.65, 0.45, 2.00],   # +z wall shelf (mid)
        [0.65, 0.15, 1.72, 1.55, 0.85, 2.00],      # +z wall cabinet (up)
        [-1.90, -1.30, -2.00, -1.10, -0.30, -1.72],  # -z wall low unit
        [1.72, 0.10, -0.40, 2.00, 0.80, 0.75],     # +x wall mid unit
        [-2.00, -0.25, -1.30, -1.70, 0.55, -0.25],  # -x wall mid unit
        [-2.00, 1.25, 0.55, 2.00, 1.50, 0.85],     # ceiling beam
        [-1.45, -1.50, 0.10, -1.15, 0.60, 0.40],   # floor-to-mid column
        [1.35, -1.50, 1.30, 1.95, -0.40, 1.90],    # +z corner sideboard
    ])
    _SPHERES_V3 = np.array([
        [0.00, 0.25, 1.58, 0.30],     # centered on the +z problem wall
        [-1.55, -0.15, 0.95, 0.28],
        [1.60, 0.95, -1.35, 0.30],
    ])
    _TINTS_V3 = np.array([
        [0.95, 0.80, 0.55],
        [0.55, 0.85, 0.95],
        [0.90, 0.60, 0.90],
        [0.60, 0.95, 0.60],
        [0.95, 0.65, 0.65],
        [0.75, 0.75, 0.95],
        [0.95, 0.90, 0.55],
        [0.65, 0.90, 0.85],
        [0.85, 0.95, 0.60],
        [0.95, 0.75, 0.85],
        [0.60, 0.80, 0.95],
    ])

    def __init__(self, cam, motion_speed: float, phase: float = 0.0,
                 scene: str = "v2", box_lo=(-2.0, -1.5, -2.0),
                 box_hi=(2.0, 1.5, 2.0)):
        self.H, self.W = int(cam["H"]), int(cam["W"])
        self.fx, self.fy = float(cam["fx"]), float(cam["fy"])
        self.cx, self.cy = float(cam["cx"]), float(cam["cy"])
        self.motion_speed = float(motion_speed)
        self.phase = float(phase)
        self.box_lo = np.array(box_lo, np.float32)
        self.box_hi = np.array(box_hi, np.float32)
        self.scene = str(scene)
        boxes, spheres, tints = Scene._BOXES, Scene._SPHERES, Scene._TINTS
        if self.scene == "v3":
            boxes = np.concatenate([Scene._BOXES, Scene._BOXES_V3])
            spheres = np.concatenate([Scene._SPHERES, Scene._SPHERES_V3])
            # tint order: walls, boxes (v2 then v3), spheres (v2 then v3)
            t, t3 = Scene._TINTS, Scene._TINTS_V3
            nb, ns = len(Scene._BOXES), len(Scene._SPHERES)
            tints = np.concatenate([
                t[:1 + nb], t3[:len(Scene._BOXES_V3)],
                t[1 + nb:1 + nb + ns], t3[len(Scene._BOXES_V3):]])
        self._BOXES = np.asarray(boxes, np.float32)
        self._SPHERES = np.asarray(spheres, np.float32)
        self._TINTS = np.asarray(tints, np.float32)

    def pose(self, i: int) -> np.ndarray:
        """Frame i's c2w (4x4 float64, OpenGL axes)."""
        return self._pose_at(self.phase + i * self.motion_speed)

    @staticmethod
    def _pose_at(t: float) -> np.ndarray:
        # fixed per-frame motion (~1.1 cm + ~0.25 deg per frame at the
        # default speed), independent of sequence length — the handheld-RGBD
        # regime trackers expect); t is the position on the orbit, which
        # repeats every unit
        ang = 0.35 * np.sin(2 * np.pi * t)      # yaw wobble (rad)
        pitch = 0.08 * np.sin(4 * np.pi * t)
        cx = 0.45 * np.sin(2 * np.pi * t)
        cz = 0.30 * np.cos(2 * np.pi * t) - 0.2
        cy = 0.10 * np.sin(6 * np.pi * t)
        Ry = np.array([[np.cos(ang), 0, np.sin(ang)],
                       [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]])
        Rx = np.array([[1, 0, 0],
                       [0, np.cos(pitch), -np.sin(pitch)],
                       [0, np.sin(pitch), np.cos(pitch)]])
        c2w = np.eye(4)
        c2w[:3, :3] = Ry @ Rx
        c2w[:3, 3] = [cx, cy, cz]
        return c2w

    def _texture(self, p: np.ndarray, obj_id: Optional[np.ndarray] = None
                 ) -> np.ndarray:
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        r = 0.5 + 0.5 * np.sin(3.1 * x + 1.7 * z)
        g = 0.5 + 0.5 * np.sin(2.3 * y + 0.9 * x + 1.0)
        b = 0.5 + 0.5 * np.sin(4.7 * z + 2.9 * y + 2.0)
        rgb = np.stack([r, g, b], axis=-1)
        # sharp-edged but APERIODIC checker: two oblique lattices with
        # incommensurate frequencies — their composite never repeats, so a
        # one-cell photometric slide is not an alias (the v1 regular
        # checker produced a stable ~20 cm tracking alias at full scale)
        c1 = (np.floor(x * 2.5 + y * 0.31) + np.floor(y * 2.5 + z * 0.27)
              + np.floor(z * 2.5 + x * 0.23)) % 2.0
        c2 = (np.floor(x * 1.618 + z * 0.517)
              + np.floor(y * 1.327 + x * 0.411)) % 2.0
        ch = 0.7 * c1 + 0.3 * c2
        # globally-unique low-frequency ramp: every point in the room gets
        # a distinct smooth base color, killing translation aliases
        ramp = np.stack([0.125 * (x + 2.0) / 4.0 - 0.0625,
                         0.125 * (y + 1.5) / 3.0 - 0.0625,
                         0.125 * (z + 2.0) / 4.0 - 0.0625], axis=-1)
        if getattr(self, "scene", "v2") == "v3":
            # v3: a mid-frequency position-unique component (three
            # incommensurate vector sinusoids, periods 1.0-1.5 m) at an
            # amplitude that makes a ~0.4 m tangential slide clearly
            # costly even on a bare wall, plus a stronger global ramp.
            # The v2 composite was TOO weak there: the two lattices agree
            # 70/30 on a one-cell slide and the 0.125 ramp moves only
            # ~0.012 color over 0.4 m (r4 flagship post-mortem).
            mid = 0.10 * np.stack([
                np.sin(5.3 * x + 2.1 * z + 0.7 * y),
                np.sin(4.1 * y + 2.7 * x + 1.9 * z + 1.0),
                np.sin(6.1 * z + 1.3 * y + 3.3 * x + 2.0)], axis=-1)
            ramp3 = np.stack([0.22 * (x + 2.0) / 4.0 - 0.11,
                              0.22 * (y + 1.5) / 3.0 - 0.11,
                              0.22 * (z + 2.0) / 4.0 - 0.11], axis=-1)
            out = (0.45 * rgb + 0.22 * ch[..., None] + mid + 0.10
                   + ramp3)
        else:
            out = 0.60 * rgb + 0.25 * ch[..., None] + 0.075 + ramp
        if obj_id is not None:
            out = out * self._TINTS[obj_id]
        # clip INSIDE (0,1): targets at exactly 0/1 demand infinite
        # pre-sigmoid logits from the color head, and with an L1 loss that
        # drives the sigmoid into gradient-dead saturation (a seed-
        # dependent color collapse observed on TPU). Natural RGBD frames
        # (Replica/TUM PNGs) are rarely exactly 0/1 either.
        return np.clip(out, 0.03, 0.97)

    def _ray_scene(self, rays_o: np.ndarray, rays_d: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Nearest hit of rays (origin 3, dirs ...x3) with the room walls
        and interior objects. Returns (t_hit ..., obj_id ... int32) where
        obj_id 0 = walls, 1.. = _BOXES rows, then _SPHERES rows."""
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / rays_d
            # interior ray/box: per axis the positive-t face distance
            t_far = np.maximum((self.box_lo - rays_o) * inv,
                               (self.box_hi - rays_o) * inv)
        t_hit = np.min(t_far, axis=-1)
        obj_id = np.zeros(t_hit.shape, np.int32)
        for k, row in enumerate(self._BOXES):
            lo, hi = row[:3], row[3:]
            with np.errstate(divide="ignore", invalid="ignore"):
                ta = (lo - rays_o) * inv
                tb = (hi - rays_o) * inv
            tnear = np.max(np.minimum(ta, tb), axis=-1)
            tfar = np.min(np.maximum(ta, tb), axis=-1)
            hit = (tnear > 1e-6) & (tnear <= tfar) & (tnear < t_hit)
            t_hit = np.where(hit, tnear, t_hit)
            obj_id = np.where(hit, k + 1, obj_id)
        a = None
        for k, row in enumerate(self._SPHERES):
            c, rad = row[:3], row[3]
            oc = rays_o - c
            if a is None:  # loop-invariant
                a = np.sum(rays_d * rays_d, axis=-1)
            bq = 2.0 * np.sum(rays_d * oc, axis=-1)
            disc = bq * bq - 4.0 * a * (np.dot(oc, oc) - rad * rad)
            ok = disc > 0
            t = np.where(ok, (-bq - np.sqrt(np.abs(disc))) / (2.0 * a),
                         np.inf)
            hit = ok & (t > 1e-6) & (t < t_hit)
            t_hit = np.where(hit, t, t_hit)
            obj_id = np.where(hit, len(self._BOXES) + 1 + k, obj_id)
        return t_hit, obj_id

    def render_frame(self, c2w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        H, W = self.H, self.W
        j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                           np.arange(W, dtype=np.float32), indexing="ij")
        dirs = np.stack([(i - np.float32(self.cx)) / np.float32(self.fx),
                         -(j - np.float32(self.cy)) / np.float32(self.fy),
                         -np.ones_like(i)], axis=-1)
        rays_d = dirs @ c2w[:3, :3].T.astype(np.float32)
        rays_o = c2w[:3, 3].astype(np.float32)
        t_hit, obj_id = self._ray_scene(rays_o, rays_d)
        hit = rays_o + rays_d * t_hit[..., None]
        color = self._texture(hit, obj_id).astype(np.float32)
        # dirs has z = -1, so the ray parameter t equals z-depth along the
        # optical axis — exactly the convention of stored dataset depth
        # (pts = rays_o + rays_d * depth reproduces the hit point).
        depth = t_hit.astype(np.float32)
        return color, depth
