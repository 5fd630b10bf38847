"""SO(3)/SE(3) exp and log on torch tensors.

Port of loopy_slam_tpu/ops/lie.py, used by the pose-graph solver.
Tangent vectors are [rho(3), phi(3)] (translation, rotation); exp is the
full SE(3) exponential with the V matrix. The small-angle branches are
torch.where on both sides, so a function never branches on a value that
lives on the device and its gradient at phi = 0 is finite.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _eye(K):
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(phi):
    """(..., 3) -> (..., 3, 3) rotation, Rodrigues with a Taylor branch.
    The angle goes through a double where, so the exact branch never sees
    theta = 0."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    small = theta2 < 1e-10
    th = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    K = hat(phi)
    K2 = K @ K
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(th)) / (th * th))
    return _eye(K) + a * K + b * K2


def so3_log(R):
    """(..., 3, 3) -> (..., 3) rotation vector."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.sin(theta)[..., None]
    th = theta[..., None]
    scale = torch.where(th < 1e-5, 0.5 + th ** 2 / 12.0,
                        th / (2.0 * s + _EPS))
    return w * scale


def _V(phi):
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    small = theta2 < 1e-10
    th = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    K = hat(phi)
    K2 = K @ K
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(th)) / (th * th))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (th - torch.sin(th)) / (th * th * th))
    return _eye(K) + b * K + c * K2


def _bottom(top):
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                       device=top.device)
    return torch.cat([top, row.expand(top.shape[:-2] + (1, 4))], -2)


def se3_exp(xi):
    """(..., 6) [rho, phi] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (_V(phi) @ rho[..., None])[..., 0]
    return _bottom(torch.cat([R, t[..., None]], -1))


def se3_log(T):
    """(..., 4, 4) -> (..., 6)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    rho = torch.linalg.solve(_V(phi), t[..., None])[..., 0]
    return torch.cat([rho, phi], -1)


def se3_inv(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    return _bottom(torch.cat([Rt, ti[..., None]], -1))
