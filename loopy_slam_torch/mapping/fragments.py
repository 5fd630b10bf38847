"""Submap (fragment) management — the long-trajectory scaling mechanism.

The port's own copy of loopy_slam_tpu/mapping/fragments.py (host numpy:
the closed segments live on the host in both packages).

Re-design of the reference's fragments_dict bookkeeping (reference
src/neural_point.py:1138-1326). The reference appends Python lists inside
an RPC server; here the ACTIVE segment is the fixed-capacity device buffer
(mapping/point_cloud.MapState) and completed segments are archived to host
numpy — they are only touched at loop closures (rigid transform) and the
final global merge, both rare host-side events.

Semantics preserved:
  * new-segment trigger: camera moved > segment_rel_trans meters or optical
    axes' cosine < segment_rot_cos vs the segment's ANCHOR keyframe
    (check_rot_trans, neural_point.py:1317-1326).
  * carry-over: points of the closing segment that project inside the new
    anchor's image (edge 20, no axis flip — init_segment,
    neural_point.py:1220-1250) are duplicated into the new segment as its
    leading block; the closing segment records which of its points were
    carried (mask) for the final merge.
  * final merge: duplicated point positions/features are chain-accumulated
    and averaged across the segments that share them
    (get_cloud_pos/get_geo_feats(end=True), neural_point.py:1252-1281,
    1435-1504).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class Fragment:
    start_idx: int
    anchor_est: np.ndarray           # (4,4) est c2w of anchor frame
    anchor_gt: np.ndarray            # (4,4)
    gt_color: np.ndarray             # (H,W,3) anchor image (ORB + segments kf)
    gt_depth: np.ndarray             # (H,W)
    anchor_des: Optional[np.ndarray]  # ORB descriptors of the anchor
    idx_start_features: int = 0      # carried-over block length
    # filled when the segment closes:
    npc: Optional[np.ndarray] = None        # (N,3)
    geo: Optional[np.ndarray] = None        # (N,c)
    col: Optional[np.ndarray] = None        # (N,c)
    carry_mask: Optional[np.ndarray] = None  # (N,) carried into next segment
    sensor_pts: Optional[np.ndarray] = None  # (M,3) raw input cloud
    sensor_rgb: Optional[np.ndarray] = None
    # registration cloud (TSDF mesh vertices once fused):
    reg_points: Optional[np.ndarray] = None
    reg_colors: Optional[np.ndarray] = None
    baseline_score: float = -1.0


def rel_trans(c2w_a: np.ndarray, c2w_b: np.ndarray) -> float:
    """||t_b - t_a|| (reference compute_rel_trans, common.py:772-777)."""
    return float(np.linalg.norm(c2w_b[:3, 3] - c2w_a[:3, 3]))


def cos_rel_rot(c2w_a: np.ndarray, c2w_b: np.ndarray) -> float:
    """Cosine between the two cameras' optical axes (R @ e_z)
    (reference compute_cos_rel_rot, common.py:759-769)."""
    return float(c2w_a[:3, :3][:, 2] @ c2w_b[:3, :3][:, 2])


class FragmentManager:
    def __init__(self, rel_trans_thresh: float, rot_cos_thresh: float,
                 H: int, W: int, fx: float, fy: float, cx: float, cy: float):
        self.fragments: List[Fragment] = []
        self.rel_trans_thresh = rel_trans_thresh
        self.rot_cos_thresh = rot_cos_thresh
        self.H, self.W = H, W
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    @property
    def active(self) -> Optional[Fragment]:
        return self.fragments[-1] if self.fragments else None

    def should_start_new(self, cur_c2w: np.ndarray) -> bool:
        if not self.fragments:
            return True
        a = self.active.anchor_est
        return (rel_trans(a, cur_c2w) > self.rel_trans_thresh
                or cos_rel_rot(a, cur_c2w) < self.rot_cos_thresh)

    def carry_over_mask(self, cur_c2w: np.ndarray,
                        npc: np.ndarray) -> np.ndarray:
        """Which points of the closing segment project inside the new anchor
        frame (init_segment parity: edge 20, NO x-axis flip, no z gate —
        neural_point.py:1223-1240)."""
        w2c = np.linalg.inv(cur_c2w)
        cam = npc @ w2c[:3, :3].T + w2c[:3, 3]
        uvz = cam @ self.K.T
        z = uvz[:, 2:3] + 1e-5
        uv = uvz[:, :2] / z
        edge = 20
        return ((uv[:, 0] < self.W - edge) & (uv[:, 0] > edge)
                & (uv[:, 1] < self.H - edge) & (uv[:, 1] > edge))

    def close_active(self, npc, geo, col, sensor_pts, sensor_rgb,
                     carry_mask: Optional[np.ndarray]):
        f = self.active
        f.npc = np.asarray(npc)
        f.geo = np.asarray(geo)
        f.col = np.asarray(col)
        f.sensor_pts = np.asarray(sensor_pts)
        f.sensor_rgb = np.asarray(sensor_rgb)
        f.carry_mask = carry_mask

    def start_fragment(self, start_idx, anchor_est, anchor_gt, gt_color,
                       gt_depth, anchor_des, idx_start_features=0):
        self.fragments.append(Fragment(
            start_idx=int(start_idx),
            anchor_est=np.asarray(anchor_est).copy(),
            anchor_gt=np.asarray(anchor_gt).copy(),
            gt_color=np.asarray(gt_color).copy(),
            gt_depth=np.asarray(gt_depth).copy(),
            anchor_des=anchor_des,
            idx_start_features=int(idx_start_features),
        ))

    # ------------------------------------------------------------------
    def merged_global(self, last_npc, last_geo, last_col):
        """Global merged cloud with duplicate averaging (end=True semantics,
        neural_point.py:1252-1281,1435-1504). The active segment's arrays
        are passed in (they live on device until now)."""
        outs_p, outs_g, outs_c = [], [], []
        prev_p = prev_g = prev_c = None
        prev_mask = None
        prev_cnt = None
        chain = [
            (f.npc.copy(), f.geo.copy(), f.col.copy(), f.carry_mask,
             f.idx_start_features) for f in self.fragments[:-1]
        ]
        chain.append((np.asarray(last_npc).copy(), np.asarray(last_geo).copy(),
                      np.asarray(last_col).copy(), None,
                      self.fragments[-1].idx_start_features
                      if self.fragments else 0))
        for i, (p, g, c, mask, idx0) in enumerate(chain):
            cnt = np.ones(len(p))
            if prev_p is not None and idx0 > 0:
                carried = prev_mask
                cnt[:idx0] += prev_cnt[carried]
                p[:idx0] += prev_p[carried]
                g[:idx0] += prev_g[carried]
                c[:idx0] += prev_c[carried]
            last = i == len(chain) - 1
            if last or mask is None:
                keep = np.ones(len(p), bool)
            else:
                keep = ~mask
            outs_p.append(p[keep] / cnt[keep, None])
            outs_g.append(g[keep] / cnt[keep, None])
            outs_c.append(c[keep] / cnt[keep, None])
            prev_p, prev_g, prev_c = p, g, c
            prev_mask = mask if mask is not None else np.zeros(len(p), bool)
            prev_cnt = cnt
        return (np.concatenate(outs_p), np.concatenate(outs_g),
                np.concatenate(outs_c))
