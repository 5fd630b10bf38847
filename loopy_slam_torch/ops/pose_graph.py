"""Pose-graph optimization: Levenberg-Marquardt with line processes for
loop-edge robustness.

Port of loopy_slam_tpu/ops/pose_graph.py (the model of Choi et al., CVPR
2015, that Open3D's GlobalOptimization implements): minimize over node
poses X and line-process weights l_e

  sum_certain r_e^T I_e r_e + sum_uncertain l_e r_e^T I_e r_e
                                + mu * (sqrt(l_e) - 1)^2

with r_e = log(Z_e^{-1} X_i^{-1} X_j) and l_e = (mu / (mu + r^T I r))^2.
The graph is solved as given (no padding: the JAX package pads nodes and
edges to powers of two only so XLA compiles one program per size), with
one dense 6N x 6N solve per LM step, in float32 on the tensors' device.
Accepting or rejecting a step is a torch.where on the device; nothing is
read back inside the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .lie import hat, se3_exp, se3_inv, se3_log


class PoseGraph(NamedTuple):
    """nodes: (N,4,4); edges i->j with measured relative pose Z (i_T_j),
    6x6 information matrices, and certainty flags (odometry=True)."""

    nodes: torch.Tensor        # (N, 4, 4)
    edge_i: torch.Tensor       # (E,) int64
    edge_j: torch.Tensor       # (E,) int64
    edge_z: torch.Tensor       # (E, 4, 4)
    edge_info: torch.Tensor    # (E, 6, 6)
    certain: torch.Tensor      # (E,) bool


def edge_residuals(nodes, g: PoseGraph):
    Xi = nodes[g.edge_i]
    Xj = nodes[g.edge_j]
    return se3_log(se3_inv(g.edge_z) @ se3_inv(Xi) @ Xj)  # (E, 6)


def _adjoint(T):
    """SE(3) adjoint in [rho, phi] ordering: [[R, hat(t)R], [0, R]]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Z = torch.zeros_like(R)
    top = torch.cat([R, hat(t) @ R], -1)
    bot = torch.cat([Z, R], -1)
    return torch.cat([top, bot], -2)


def optimize(g: PoseGraph, preference_loop_closure: float = 5.0,
             max_iters: int = 30, lm_lambda: float = 1e-6):
    """LM with line processes. Returns (nodes, line_weights).

    Node 0 is gauge-fixed. Pruning edges by weight is the caller's
    decision from the returned line weights.
    """
    N = g.nodes.shape[0]
    E = g.edge_i.shape[0]
    dev, dt = g.nodes.device, g.nodes.dtype
    mu = preference_loop_closure
    eye6N = torch.eye(N * 6, dtype=dt, device=dev)
    fix = torch.arange(N * 6, device=dev) < 6
    fix2 = fix[:, None] | fix[None, :]
    ar = torch.arange(E, device=dev)

    def quad(r):
        return torch.einsum("ei,eij,ej->e", r, g.edge_info, r)

    def line_weights(r):
        w = (mu / (mu + quad(r))) ** 2
        return torch.where(g.certain, torch.ones_like(w), w)

    def cost(nd, l):
        return torch.sum(l * quad(edge_residuals(nd, g)))

    nodes = g.nodes
    lam = torch.tensor(lm_lambda, dtype=dt, device=dev)
    l = torch.ones(E, dtype=dt, device=dev)
    for _ in range(max_iters):
        # Choi et al. alternation: update X with the CURRENT line weights
        # (l = 1 at first), then refresh l from the new residuals
        r = edge_residuals(nodes, g)
        # right-perturbation Jacobians (small-residual approximation):
        # dr/d(delta_j) = I, dr/d(delta_i) = -Ad(Xj^-1 Xi)
        Ji = -_adjoint(se3_inv(nodes[g.edge_j]) @ nodes[g.edge_i])
        Jfull = torch.zeros((E, 6, N, 6), dtype=dt, device=dev)
        Jfull[ar, :, g.edge_i, :] += Ji
        Jfull[ar, :, g.edge_j, :] += torch.eye(6, dtype=dt, device=dev)
        W = l[:, None, None] * g.edge_info
        Jb = Jfull.reshape(E, 6, N * 6)
        WJ = W @ Jb
        H = torch.einsum("eka,ekb->ab", Jb, WJ)
        b = torch.einsum("eka,ek->a", WJ, r)
        H = torch.where(fix2, eye6N, H)
        b = torch.where(fix, torch.zeros_like(b), b)
        delta = -torch.linalg.solve(H + lam * eye6N, b)
        # trust region: cap each node's update at 0.5 in the se(3) norm
        d6 = delta.reshape(N, 6)
        norms = torch.linalg.norm(d6, dim=-1, keepdim=True)
        d6 = d6 * torch.clamp(0.5 / torch.clamp(norms, min=1e-12), max=1.0)
        new_nodes = nodes @ se3_exp(d6)
        new_cost = cost(new_nodes, l)
        better = torch.isfinite(new_cost) & (new_cost < cost(nodes, l))
        nodes = torch.where(better, new_nodes, nodes)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
        l = line_weights(edge_residuals(nodes, g))
    return nodes, l


def build_odometry_chain(poses: np.ndarray, info_scale: float = 1.0):
    """Odometry edges k -> k+1 from a pose chain (host helper)."""
    n = len(poses)
    ei = np.arange(n - 1, dtype=np.int32)
    ej = ei + 1
    z = np.stack([np.linalg.inv(poses[i]) @ poses[i + 1]
                  for i in range(n - 1)])
    info = np.tile(np.eye(6) * info_scale, (n - 1, 1, 1))
    return ei, ej, z, info
