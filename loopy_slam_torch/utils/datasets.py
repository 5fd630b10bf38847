"""RGBD datasets for the port (numpy only, no cv2): the file path of
`BaseDataset`, the `Replica`, `ScanNet` and `TUM_RGBD` loaders and the
procedural `Synthetic` room, copied from loopy_slam_tpu/utils/datasets.py.

`__getitem__` -> (index, color float HxWx3 in [0,1] RGB, depth float HxW in
meters, gt c2w 4x4 float32), numpy arrays. Files are read by the port's
own PNG and JPEG readers (utils/imageio.py); color is undistorted (depth
is not) with the camera's `distortion`, resized to depth's size when it
differs (ScanNet's 1296x968 color over 640x480 depth), then both are
cropped by `crop_edge`. Every loader flips the Y and Z columns of c2w
(OpenGL convention); ScanNet's invalid ground-truth poses stay inf.
`Synthetic.gt_mesh` is the room's analytic ground-truth mesh for the
reconstruction metrics. Not ported yet (ROADMAP.md Queue 1 item 11b-iii):
the Azure and CoFusion loaders, CoFusion's EXR depth and the `crop_size`
resize; the loader raises for the last two.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .imageio import (read_jpeg, read_png, remap_linear, resize_linear,
                      undistort_map)


def as_intrinsics_matrix(intr) -> np.ndarray:
    K = np.eye(3)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = intr
    return K


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to loopy_slam_torch yet "
                              "(ROADMAP.md Queue 1 item 11)")


class BaseDataset:
    def __init__(self, cfg, input_folder: Optional[str] = None):
        self.name = cfg["dataset"]
        self.png_depth_scale = cfg["cam"]["png_depth_scale"]
        cam = cfg["cam"]
        self.H, self.W = cam["H"], cam["W"]
        self.fx, self.fy = cam["fx"], cam["fy"]
        self.cx, self.cy = cam["cx"], cam["cy"]
        self.distortion = (np.array(cam["distortion"])
                           if "distortion" in cam else None)
        self.crop_size = cam.get("crop_size")
        self.crop_edge = cam["crop_edge"]
        self.input_folder = input_folder or cfg["data"]["input_folder"]
        self.color_paths: List[str] = []
        self.depth_paths: List[str] = []
        self.poses: List[np.ndarray] = []
        self.n_img = 0
        self._undistort_taps = None  # remap taps of the camera, made once

    def __len__(self):
        return self.n_img

    def _read_depth(self, path: str) -> np.ndarray:
        if path.endswith(".png"):
            d = read_png(path)
            if d.ndim != 2:
                raise ValueError(f"{path}: depth PNG is not single-channel")
            return d.astype(np.float32) / self.png_depth_scale
        if path.endswith(".exr"):
            _not_ported("EXR depth (CoFusion)")
        raise ValueError(f"unsupported depth format: {path}")

    def _read_color(self, path: str) -> np.ndarray:
        """uint8 (H, W, 3) RGB, as cv2.imread's color mode then BGR->RGB
        gives it: gray is replicated, alpha dropped."""
        if path.lower().endswith((".jpg", ".jpeg")):
            return read_jpeg(path)
        if not path.endswith(".png"):
            raise ValueError(f"unsupported color format: {path}")
        c = read_png(path)
        if c.dtype != np.uint8:
            raise ValueError(f"{path}: 16-bit color is not supported")
        if c.ndim == 2:
            return np.repeat(c[..., None], 3, axis=2)
        return c[..., :3]

    def __getitem__(self, index: int):
        if self.crop_size is not None:
            _not_ported("cam.crop_size (the color/depth resize)")
        color = self._read_color(self.color_paths[index])
        depth = self._read_depth(self.depth_paths[index])
        if self.distortion is not None:
            # the color's own size, as cv2.undistort takes it
            taps = self._undistort_taps
            hw = color.shape[:2]
            if taps is None or taps[0].shape[1] != hw[0] * hw[1]:
                K = as_intrinsics_matrix([self.fx, self.fy, self.cx,
                                          self.cy])
                taps = undistort_map(K, self.distortion, *hw)
                self._undistort_taps = taps
            color = remap_linear(color, taps)
        color = color.astype(np.float32) / 255.0
        # to depth's size (a copy when the sizes agree), as cv2.resize does
        H, W = depth.shape
        color = resize_linear(color, (W, H))
        e = self.crop_edge
        if e > 0:
            color = color[e:-e, e:-e]
            depth = depth[e:-e, e:-e]
        return index, color, depth, self.poses[index].astype(np.float32)


def _flip_yz(c2w: np.ndarray) -> np.ndarray:
    c2w = c2w.copy()
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    return c2w


class Replica(BaseDataset):
    """A Replica scene folder: results/frame*.jpg color, results/depth*.png
    depth and traj.txt, one row-major 4x4 c2w a line."""

    def __init__(self, cfg, input_folder=None):
        super().__init__(cfg, input_folder)
        self.color_paths = sorted(
            glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        self.depth_paths = sorted(
            glob.glob(f"{self.input_folder}/results/depth*.png"))
        self.n_img = len(self.color_paths)
        with open(f"{self.input_folder}/traj.txt") as f:
            lines = f.readlines()
        self.poses = [_flip_yz(np.array(list(map(float, line.split())))
                               .reshape(4, 4))
                      for line in lines[:self.n_img]]


class ScanNet(BaseDataset):
    """A ScanNet scene folder: frames/color/<i>.jpg, frames/depth/<i>.png
    and frames/pose/<i>.txt (a 4x4 c2w, inf where the scan has no valid
    pose), each sorted by the integer i."""

    def __init__(self, cfg, input_folder=None):
        super().__init__(cfg, input_folder)
        base = os.path.join(self.input_folder, "frames")

        def key(p):
            return int(os.path.basename(p).split(".")[0])

        self.color_paths = sorted(
            glob.glob(os.path.join(base, "color", "*.jpg")), key=key)
        self.depth_paths = sorted(
            glob.glob(os.path.join(base, "depth", "*.png")), key=key)
        self.n_img = len(self.color_paths)
        for p in sorted(glob.glob(os.path.join(base, "pose", "*.txt")),
                        key=key):
            self.poses.append(_flip_yz(np.loadtxt(p).reshape(4, 4)))


class TUM_RGBD(BaseDataset):
    """A TUM RGB-D sequence folder: rgb.txt, depth.txt and groundtruth.txt
    (or pose.txt); color and depth frames associated by timestamp (within
    0.08 s), thinned to 32 frames a second, poses relative to the first
    frame."""

    def __init__(self, cfg, input_folder=None):
        super().__init__(cfg, input_folder)
        self.color_paths, self.depth_paths, self.poses = self._load(
            self.input_folder, frame_rate=32)
        self.n_img = len(self.color_paths)

    @staticmethod
    def _parse_list(path, skiprows=0):
        import warnings

        with warnings.catch_warnings():
            # numpy 2 warns on the files' leading comment lines
            warnings.simplefilter("ignore", UserWarning)
            return np.loadtxt(path, delimiter=" ", dtype=np.str_,
                              skiprows=skiprows)

    @staticmethod
    def _associate(t_img, t_depth, t_pose, max_dt=0.08):
        out = []
        for i, t in enumerate(t_img):
            j = np.argmin(np.abs(t_depth - t))
            k = np.argmin(np.abs(t_pose - t))
            if abs(t_depth[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                out.append((i, j, k))
        return out

    def _load(self, datapath, frame_rate=-1):
        from scipy.spatial.transform import Rotation

        pose_file = os.path.join(datapath, "groundtruth.txt")
        if not os.path.isfile(pose_file):
            pose_file = os.path.join(datapath, "pose.txt")
        image_data = self._parse_list(os.path.join(datapath, "rgb.txt"))
        depth_data = self._parse_list(os.path.join(datapath, "depth.txt"))
        pose_data = self._parse_list(pose_file, skiprows=1)
        pose_vecs = pose_data[:, 1:].astype(np.float64)
        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        assoc = self._associate(t_img, t_depth, t_pose)
        indices = [0]
        for i in range(1, len(assoc)):
            t0 = t_img[assoc[indices[-1]][0]]
            t1 = t_img[assoc[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indices.append(i)
        images, depths, poses = [], [], []
        inv_pose = None
        for ix in indices:
            i, j, k = assoc[ix]
            images.append(os.path.join(datapath, str(image_data[i, 1])))
            depths.append(os.path.join(datapath, str(depth_data[j, 1])))
            c2w = np.eye(4)
            c2w[:3, :3] = Rotation.from_quat(pose_vecs[k][3:]).as_matrix()
            c2w[:3, 3] = pose_vecs[k][:3]
            if inv_pose is None:
                inv_pose = np.linalg.inv(c2w)
                c2w = np.eye(4)
            else:
                c2w = inv_pose @ c2w
            poses.append(_flip_yz(c2w))
        return images, depths, poses


# ---------------------------------------------------------------------------
# Synthetic procedural dataset (test/bench fixture; no downloads needed)
# ---------------------------------------------------------------------------

class Synthetic(BaseDataset):
    """Analytic RGBD of a furnished, textured box room.

    Rays are intersected with the interior of an axis-aligned box plus a
    fixed set of interior primitives (boxes and spheres — "furniture");
    color is a procedural texture of the hit point. Poses follow a slow
    orbit with small rotations, the same motion regime as a handheld RGBD
    camera. Everything is deterministic.

    Scene v2 rationale (the v1 empty box was degenerate two ways, and both
    bit at full scale):
      * geometry — with a single wall filling the view, point-to-plane
        ICP/tracking has a 3-DoF null space (slides along the plane kept
        residual ≈ 0); the interior objects give depth structure in every
        view so registration and tracking are well-posed, like the
        furnished rooms of the real Replica release.
      * texture — the v1 checker + commensurate sinusoids were periodic;
        at frame ~1810 of the 2000-frame fixture the tracker locked onto a
        one-period-shifted photometric alias (~20 cm / 7 deg, stable).
        v2 uses two incommensurate oblique lattices plus a low-frequency
        position ramp that makes every surface point globally unique.
    """

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

    def __init__(self, cfg, input_folder=None):
        super().__init__(cfg, input_folder)
        data = cfg["data"]
        self.n_img = int(data.get("n_frames", 40))
        self.motion_speed = float(data.get("motion_speed", 0.004))
        self.box_lo = np.array(data.get("box_lo", [-2.0, -1.5, -2.0]))
        self.box_hi = np.array(data.get("box_hi", [2.0, 1.5, 2.0]))
        self.scene = str(data.get("scene", "v2"))
        if self.scene == "v3":
            self._BOXES = np.concatenate(
                [Synthetic._BOXES, Synthetic._BOXES_V3])
            self._SPHERES = np.concatenate(
                [Synthetic._SPHERES, Synthetic._SPHERES_V3])
            # tint order: walls, boxes (v2 then v3), spheres (v2 then v3)
            t = Synthetic._TINTS
            t3 = Synthetic._TINTS_V3
            nb, ns = len(Synthetic._BOXES), len(Synthetic._SPHERES)
            self._TINTS = np.concatenate([
                t[:1 + nb], t3[:len(Synthetic._BOXES_V3)],
                t[1 + nb:1 + nb + ns],
                t3[len(Synthetic._BOXES_V3):]])
        # float32 instance copies for the render hot path: the procedural
        # render is memory-bandwidth bound on this host (816k rays x ~18
        # primitives of large-array numpy ops); f64 -> f32 halves the
        # traffic (~2x wall) and its ~1e-7 relative drift is far below
        # the fixture formats' own quantization (uint16 depth quantum
        # 1.5e-4 m, JPEG q92 color)
        self._BOXES = np.asarray(self._BOXES, np.float32)
        self._SPHERES = np.asarray(self._SPHERES, np.float32)
        self._TINTS = np.asarray(self._TINTS, np.float32)
        self.box_lo = self.box_lo.astype(np.float32)
        self.box_hi = self.box_hi.astype(np.float32)
        self.poses = [self._pose(i) for i in range(self.n_img)]
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def _pose(self, i: int) -> np.ndarray:
        # fixed per-frame motion (~1.1 cm + ~0.25 deg per frame at the
        # default speed), independent of sequence length — the handheld-RGBD
        # regime trackers expect; data.motion_speed=1/n gives a full orbit
        # (a guaranteed revisit) every n frames
        t = i * self.motion_speed
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

    def __getitem__(self, index: int):
        # thread-safe vs the run-loop prefetcher: read/insert via local
        # references only (never check-then-index the shared dict — a
        # concurrent clear() between the two would raise); worst case a
        # frame renders twice
        item = self._cache.get(index)
        if item is None:
            c2w = self.poses[index]
            item = self.render_frame(c2w)
            if len(self._cache) > 8:
                self._cache.clear()
            self._cache[index] = item
        color, depth = item
        return index, color, depth, self.poses[index].astype(np.float32)

    def gt_mesh(self, divisions: int = 60):
        """Analytic ground-truth mesh of the room (walls + interior
        objects), for reconstruction evaluation without downloads."""
        verts_all, faces_all = [], []
        n0 = 0

        def add_grid_face(axis, val, lo, hi, div_a, div_b):
            nonlocal n0
            a, b = [i for i in range(3) if i != axis]
            ua = np.linspace(lo[a], hi[a], div_a)
            ub = np.linspace(lo[b], hi[b], div_b)
            A, B = np.meshgrid(ua, ub, indexing="ij")
            V = np.zeros((div_a, div_b, 3))
            V[..., axis] = val
            V[..., a] = A
            V[..., b] = B
            verts_all.append(V.reshape(-1, 3))
            idx = np.arange(div_a * div_b).reshape(div_a, div_b)
            q = np.stack([idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:],
                          idx[1:, 1:]], -1).reshape(-1, 4)
            faces_all.append(n0 + np.concatenate(
                [q[:, [0, 1, 2]], q[:, [1, 3, 2]]], 0))
            n0 += div_a * div_b

        def add_box(lo, hi, div_per_m):
            for axis in range(3):
                a, b = [i for i in range(3) if i != axis]
                da = max(2, int(np.ceil((hi[a] - lo[a]) * div_per_m)))
                db = max(2, int(np.ceil((hi[b] - lo[b]) * div_per_m)))
                for val in (lo[axis], hi[axis]):
                    add_grid_face(axis, val, lo, hi, da, db)

        # walls at the requested resolution, objects at matched density
        div_per_m = divisions / float((self.box_hi - self.box_lo).max())
        add_box(self.box_lo, self.box_hi, div_per_m)
        for row in self._BOXES:
            add_box(row[:3], row[3:], div_per_m)
        for row in self._SPHERES:
            c, rad = row[:3], row[3]
            nu = max(8, int(np.ceil(2 * np.pi * rad * div_per_m)))
            nv = max(5, nu // 2)
            th = np.linspace(0, np.pi, nv)
            ph = np.linspace(0, 2 * np.pi, nu)
            T, P = np.meshgrid(th, ph, indexing="ij")
            V = np.stack([c[0] + rad * np.sin(T) * np.cos(P),
                          c[1] + rad * np.cos(T),
                          c[2] + rad * np.sin(T) * np.sin(P)], -1)
            verts_all.append(V.reshape(-1, 3))
            idx = np.arange(nv * nu).reshape(nv, nu)
            q = np.stack([idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:],
                          idx[1:, 1:]], -1).reshape(-1, 4)
            faces_all.append(n0 + np.concatenate(
                [q[:, [0, 1, 2]], q[:, [1, 3, 2]]], 0))
            n0 += nv * nu
        return np.concatenate(verts_all), np.concatenate(faces_all)


dataset_dict = {"replica": Replica, "scannet": ScanNet, "tumrgbd": TUM_RGBD,
                "synthetic": Synthetic}


def get_dataset(cfg, input_folder: Optional[str] = None) -> BaseDataset:
    name = cfg["dataset"]
    if name not in dataset_dict:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP.md Queue 1 item "
            "11b-iii); the port runs 'replica', 'scannet', 'tumrgbd' and "
            "the procedural 'synthetic' scene")
    ds = dataset_dict[name](cfg, input_folder)
    if len(ds) == 0:
        raise FileNotFoundError(
            f"dataset {name!r} found no frames under {ds.input_folder!r}: "
            "set data.input_folder (or --input_folder) to the scene "
            "directory")
    return ds
