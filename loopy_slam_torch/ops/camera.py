"""Camera geometry: quaternion poses, ray generation, alignment.

Port of loopy_slam_tpu/ops/camera.py with the same conventions: c2w uses
the OpenGL-style axis flip (ray dirs [(i-cx)/fx, -(j-cy)/fy, -1]); poses
are a 7-vector [qw qx qy qz tx ty tz] with an unnormalized quaternion
(normalization happens inside quat_to_rot). Tensor functions are
differentiable; the `np_`/host functions take and return numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unnormalized quaternion(s) [..., 4] (w,x,y,z) -> rotation [..., 3, 3]."""
    qr, qi, qj, qk = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    r = torch.stack(
        [
            1 - two_s * (qj**2 + qk**2),
            two_s * (qi * qj - qk * qr),
            two_s * (qi * qk + qj * qr),
            two_s * (qi * qj + qk * qr),
            1 - two_s * (qi**2 + qk**2),
            two_s * (qj * qk - qi * qr),
            two_s * (qi * qk - qj * qr),
            two_s * (qj * qk + qi * qr),
            1 - two_s * (qi**2 + qj**2),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix (3,3) -> unit quaternion (w,x,y,z). Host-side
    (Shepperd's method)."""
    R = np.asarray(R, dtype=np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def c2w_from_tensor(t7: torch.Tensor) -> torch.Tensor:
    """Pose 7-vector [quat(4), trans(3)] -> 3x4 c2w (differentiable).
    Accepts [..., 7]."""
    R = quat_to_rot(t7[..., :4])
    T = t7[..., 4:]
    return torch.cat([R, T[..., :, None]], dim=-1)


def tensor_from_c2w(c2w: np.ndarray) -> np.ndarray:
    """4x4 (or 3x4) c2w -> pose 7-vector [quat, trans]. Host-side."""
    c2w = np.asarray(c2w)
    q = rot_to_quat(c2w[:3, :3])
    return np.concatenate([q, c2w[:3, 3]], axis=0).astype(np.float32)


def c2w_to_4x4(c2w34: torch.Tensor) -> torch.Tensor:
    """Append the homogeneous bottom row to a 3x4 pose."""
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=c2w34.dtype,
                          device=c2w34.device)
    return torch.cat([c2w34, bottom], dim=0)


def np_c2w_from_tensor(t7: np.ndarray) -> np.ndarray:
    """Pose 7-vector -> 4x4 c2w, pure numpy."""
    q = np.asarray(t7[:4], np.float64)
    qr, qi, qj, qk = q
    s = 2.0 / np.dot(q, q)
    R = np.array([
        [1 - s * (qj**2 + qk**2), s * (qi*qj - qk*qr), s * (qi*qk + qj*qr)],
        [s * (qi*qj + qk*qr), 1 - s * (qi**2 + qk**2), s * (qj*qk - qi*qr)],
        [s * (qi*qk - qj*qr), s * (qj*qk + qi*qr), 1 - s * (qi**2 + qj**2)],
    ])
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R
    out[:3, 3] = t7[4:]
    return out


def rays_from_uv(i, j, c2w, fx, fy, cx, cy):
    """Pixel coords (i=col, j=row, float) + c2w -> (rays_o, rays_d).

    c2w may be 3x4 or 4x4, or batched (F, 3|4, 4) with i, j of shape (F, P).
    """
    dirs = torch.stack(
        [(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)], dim=-1)
    R = c2w[..., :3, :3]
    rays_d = torch.matmul(dirs, R.transpose(-1, -2))
    rays_o = c2w[..., :3, 3]
    if c2w.dim() == 3:
        rays_o = rays_o[:, None, :]
    return rays_o.expand(rays_d.shape), rays_d


def get_rays(H, W, fx, fy, cx, cy, c2w):
    """Rays for a full image, row-major (H, W, 3)."""
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=c2w.device),
        torch.arange(W, dtype=torch.float32, device=c2w.device),
        indexing="ij")
    return rays_from_uv(i, j, c2w, fx, fy, cx, cy)


def project_points(points, w2c, fx, fy, cx, cy):
    """World points (N,3) -> pixel uv (N,2) and camera-frame z (N,).

    Camera coords get x *= -1 before applying K, and depth along the
    optical axis is -z (the camera looks down -z).
    """
    R, t = w2c[:3, :3], w2c[:3, 3]
    cam = torch.matmul(points, R.T) + t
    cam = cam * torch.tensor([-1.0, 1.0, 1.0], dtype=cam.dtype,
                             device=cam.device)
    z = cam[:, 2]
    u = fx * cam[:, 0] / (z + 1e-10) + cx
    v = fy * cam[:, 1] / (z + 1e-10) + cy
    return torch.stack([u, v], dim=-1), z


def invert_c2w(c2w: torch.Tensor) -> torch.Tensor:
    """Invert a rigid 4x4 (or 3x4) transform analytically."""
    R = c2w[:3, :3]
    t = c2w[:3, 3]
    Rinv = R.T
    tinv = -Rinv @ t
    top = torch.cat([Rinv, tinv[:, None]], dim=1)
    return c2w_to_4x4(top)


def horn_align(model: np.ndarray, data: np.ndarray):
    """Horn closed-form SE(3) alignment of two (3,N) trajectories.
    Host-side. Returns (rot, trans, trans_error per point)."""
    model = np.asarray(model, dtype=np.float64)
    data = np.asarray(data, dtype=np.float64)
    model_zerocentered = model - model.mean(1, keepdims=True)
    data_zerocentered = data - data.mean(1, keepdims=True)
    W = np.zeros((3, 3))
    for column in range(model.shape[1]):
        W += np.outer(model_zerocentered[:, column],
                      data_zerocentered[:, column])
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)
    model_aligned = rot @ model + trans
    alignment_error = model_aligned - data
    trans_error = np.sqrt(np.sum(alignment_error * alignment_error, axis=0))
    return rot, trans, trans_error
