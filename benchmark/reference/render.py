"""The plain reference of one tracking and one mapping iteration: the
neighbour gather, both decoders from their widths, compositing, the two
losses, their gradients by autograd, and Adam. Plain PyTorch; it imports
nothing of the program. It follows the published description of
Point-SLAM's renderer (Sandström et al., ICCV 2023) as the program states
it: Gaussian-Fourier embeddings, a 5-block ReLU geometry trunk of width 32
and a 5-block Softplus(100) color trunk of width 128, each with a
per-block injection of the interpolated neighbour feature and a skip
concat of the embedding after block 2; the color branch's relative-position
neighbour transform; inverse-distance interpolation inside the query
radius; occupancy alpha compositing.

Precision: `dt` is the dtype the arithmetic runs in. With float32 the
trunk matmuls take bf16-rounded operands and sum in float32, as the
configuration states (`model.bf16_trunks`); with bfloat16 (the control)
every tensor and every operation is bfloat16.

A record is what the benchmark captured of one iteration of the window:
the iteration's inputs (pose or features, decoder parameters, the pool's
rows it drew, the program's neighbour ids, its random draws) and what the
program made of them (loss, gradients as Adam received them).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

N_BLOCKS = 5
SKIP = 2


def _mm(x, w, dt):
    if dt == torch.float32:
        return x.bfloat16().float() @ w.bfloat16().float()
    return x @ w


def fourier_embed(p, B, concat_cos: bool):
    t = (2.0 * math.pi) * p[..., :, None] * B
    x = (t[..., 0, :] + t[..., 1, :]) + t[..., 2, :]
    return torch.cat([torch.sin(x), torch.cos(x)], -1) if concat_cos \
        else torch.sin(x)


def softplus100(x):
    return torch.logaddexp(x.new_zeros(()), 100.0 * x) / 100.0


def _trunk(P, part, emb, c, act, dt):
    h = emb
    for i in range(N_BLOCKS):
        h = act(_mm(h, P[f"{part}.lin.{i}.w"], dt) + P[f"{part}.lin.{i}.b"])
        h = h + (_mm(c, P[f"{part}.fc_c.{i}.w"], dt) + P[f"{part}.fc_c.{i}.b"])
        if i == SKIP:
            h = torch.cat([emb, h], dim=-1)
    return _mm(h, P[f"{part}.out.w"], dt) + P[f"{part}.out.b"]


def geo_forward(P, p, c, dt):
    emb = fourier_embed(p, P["geo.B"], False)
    return _trunk(P, "geo", emb, c, torch.relu, dt)[..., 0]


def col_forward(P, p, c, dt):
    emb = fourier_embed(p, P["col.B"], True)
    return _trunk(P, "col", emb, c, softplus100, dt)


def neighbor_transform(P, feats, rel, dt):
    emb = fourier_embed(rel, P["col.B_rel"], True)
    x = torch.cat([emb, feats], dim=-1)
    h = softplus100(_mm(x, P["col.neigh.w1"], dt) + P["col.neigh.b1"])
    return _mm(h, P["col.neigh.w2"], dt) + P["col.neigh.b2"]


def interp_weights(D, r2, weighting):
    if weighting == "distance":
        w = 1.0 / (D + 1e-10)
    else:
        w = torch.exp(-20.0 * torch.sqrt(torch.clamp(D, min=1e-12)))
    w = w * (D <= r2).to(w.dtype).detach()
    return w / (torch.sum(torch.abs(w), dim=-1, keepdim=True) + 1e-12)


def interpolate(feats, w, has, noise):
    c = torch.sum(w[..., None] * feats, dim=-2)
    return torch.where(has[..., None], c, 0.01 * noise)


def soft_clamp(x):
    """x / (1 + |x|/12) inside |x| <= 24, a rational decline toward
    -16 * sign(x) beyond (the program's guard against sigmoid latch)."""
    a = torch.abs(x)
    core = x / (1.0 + a / 12.0)
    excess = torch.clamp(a - 24.0, min=0.0)
    decline = 24.0 * excess / (excess + 24.0 * 9.0)
    return torch.where(a <= 24.0, core, torch.sign(x) * (8.0 - decline))


def composite(rgb, occ, z, coef):
    alpha = torch.reciprocal(1.0 + torch.exp(-coef * occ))
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    w = alpha * trans
    wsum = torch.sum(w, -1, keepdim=True) + 1e-10
    color = torch.sum(w[..., None] * rgb, -2) / wsum
    depth = torch.sum(w * z, -1) / wsum[..., 0]
    dev = z - depth[..., None]
    return depth, torch.sum(w * dev * dev, -1), color


def masked_median(x, mask):
    """The lower median of the masked-in entries."""
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))))
    idx = torch.clamp(torch.div(torch.sum(mask) - 1, 2,
                                rounding_mode="floor"), min=0)
    return xs.values.index_select(0, idx.reshape(1)).reshape(())


def masked_max(x, mask, fill=0.0):
    return torch.max(torch.where(mask, x, torch.full_like(x, fill)))


def masked_mean(x, mask):
    n = torch.clamp(torch.sum(mask), min=1)
    return torch.sum(torch.where(mask, x, torch.zeros_like(x))) / n


def quat_to_rot(q):
    qr, qi, qj, qk = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    s = 2.0 / torch.sum(q * q, dim=-1)
    r = torch.stack([1 - s * (qj ** 2 + qk ** 2), s * (qi * qj - qk * qr),
                     s * (qi * qk + qj * qr), s * (qi * qj + qk * qr),
                     1 - s * (qi ** 2 + qk ** 2), s * (qj * qk - qi * qr),
                     s * (qi * qk - qj * qr), s * (qj * qk + qi * qr),
                     1 - s * (qi ** 2 + qj ** 2)], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def rays(i, j, cam7, fx, fy, cx, cy):
    """Rays through pixels (i col, j row) of the camera at pose cam7
    ([qw qx qy qz tx ty tz], OpenGL axes)."""
    R = quat_to_rot(cam7[:4])
    dirs = torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)],
                       dim=-1)
    rd = dirs @ R.transpose(-1, -2)
    return cam7[4:].expand(rd.shape), rd


def decode(P, pts, pos, feats, I, empty, nn, rq, noises, ro, stage, dt):
    """Occupancy logits and colors of the samples pts (N, 3) from their
    neighbours I (N, k) in the map (pos, feats); empty marks neighbour
    slots the k-NN left empty, nn the in-radius counts, rq the radius."""
    n = pts.shape[0]
    c = feats.shape[1] // 2
    flat = I.reshape(-1).long()
    nb_feat = feats.index_select(0, flat).reshape(n, -1, 2 * c)
    nb_pos = pos.index_select(0, flat).reshape(n, -1, 3).detach()
    diff = nb_pos - pts[:, None, :]
    D = torch.sum(diff * diff, dim=-1)
    D = torch.where(empty, torch.full((), 1e4, dtype=D.dtype,
                                      device=D.device), D)
    r2 = rq * rq
    if r2.dim() == 1:
        r2 = r2[:, None]
    w = interp_weights(D, r2, ro["weighting"])
    has = nn >= ro["min_nn_num"]
    occ = geo_forward(P, pts, interpolate(nb_feat[..., :c], w, has,
                                          noises[0]), dt)
    occ = torch.where(has, occ, torch.full((), -100.0, dtype=occ.dtype,
                                           device=occ.device))
    if stage == "geometry":
        return occ, torch.zeros((n, 3), dtype=pts.dtype,
                                device=pts.device), has
    col_n = nb_feat[..., c:]
    if ro["encode_rel_pos_in_col"]:
        col_n = neighbor_transform(P, col_n, nb_pos - pts[:, None, :], dt)
    rgb = col_forward(P, pts, interpolate(col_n, w, has, noises[1]), dt)
    return occ, torch.sigmoid(soft_clamp(rgb)), has


def _cast(x, dt):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dt)
    return x


def track_loss(rec: Dict, dt=torch.float32):
    """The tracking loss of the captured iteration and its gradient by the
    pose: (loss, d loss / d cam7)."""
    o, ro = rec["opts"], rec["ropts"]
    cam7 = rec["cam7"].to(dt).requires_grad_(True)
    P = {k: _cast(v, dt) for k, v in rec["params"].items()}
    i, j, d, c, z = (_cast(rec[k], dt) for k in ("i", "j", "d", "c", "z"))
    inside = rec["inside"]
    R, S = z.shape
    ro_, rd = rays(i, j, cam7, o["fx"], o["fy"], o["cx"], o["cy"])
    pts = (ro_[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
    rq = (torch.as_tensor(ro["radius_query"], dtype=dt, device=z.device)
          if rec["rq"] is None else rec["rq"].to(dt).repeat_interleave(S))
    occ, rgb, _ = decode(P, pts, _cast(rec["pos"], dt),
                         _cast(rec["feats"], dt), rec["I"], rec["empty"],
                         rec["nn"], rq, [_cast(n, dt) for n in rec["noises"]],
                         ro, "color", dt)
    depth, var, color = composite(rgb.reshape(R, S, 3), occ.reshape(R, S),
                                  z, ro["sigmoid_coef"])
    depth = torch.where(d > 0, depth, torch.zeros((), dtype=dt,
                                                  device=d.device))
    var = var.detach()
    finite = torch.isfinite(depth) & torch.isfinite(var)
    tmp = torch.abs(d - depth) / torch.sqrt(var + 1e-10)
    if o["handle_dynamic"]:
        gate = tmp < 10.0 * masked_mean(tmp, inside)
    else:
        gate = torch.abs(d - depth) < 10.0 * masked_median(
            torch.abs(d - depth), inside)
    mask = gate & (d > 0) & finite & inside
    zero = torch.zeros((), dtype=dt, device=d.device)
    geo = torch.sum(torch.where(mask, torch.clamp(tmp, 0.0, 1e3), zero))
    col = torch.sum(torch.where(mask[:, None], torch.abs(c - color), zero))
    loss = geo + (o["w_color_loss"] * col if o["use_color_in_tracking"]
                  else 0.0)
    (g,) = torch.autograd.grad(loss, [cam7])
    return loss.detach(), g


def map_loss(rec: Dict, dt=torch.float32):
    """The mapping loss of the captured iteration and its gradients by the
    trainable decoder parameters and the features: (loss, {name: grad},
    feature grad)."""
    o, ro = rec["opts"], rec["ropts"]
    P = {k: _cast(v, dt) for k, v in rec["params"].items()}
    trained = [k for k, on in rec["dec_on"].items() if on]
    for k in trained:
        P[k] = P[k].detach().requires_grad_(True)
    feats = _cast(rec["feats"], dt).detach().requires_grad_(True)
    d, c, z, pts = (_cast(rec[k], dt) for k in ("d", "c", "z", "pts"))
    valid = rec["valid"]
    R, S = z.shape
    med = masked_median(d, valid)
    mx = masked_max(d, valid)
    inside = valid & (d <= torch.minimum(10.0 * med, 1.2 * mx))
    rq = (torch.as_tensor(ro["radius_query"], dtype=dt, device=z.device)
          if rec["rq"] is None else rec["rq"].to(dt).repeat_interleave(S))
    occ, rgb, has = decode(P, pts.reshape(-1, 3), _cast(rec["pos"], dt),
                           feats, rec["I"], rec["empty"], rec["nn"], rq,
                           [_cast(n, dt) for n in rec["noises"]], ro,
                           rec["stage"], dt)
    valid_ray = torch.sum(has.reshape(R, S), -1) >= (S // 2 + 1)
    depth, _, color = composite(rgb.reshape(R, S, 3), occ.reshape(R, S), z,
                                ro["sigmoid_coef"])
    depth = torch.where(d > 0, depth, torch.zeros((), dtype=dt,
                                                  device=d.device))
    m = (d > 0) & valid_ray & torch.isfinite(depth) & inside
    zero = torch.zeros((), dtype=dt, device=d.device)
    loss = torch.sum(torch.where(m, torch.abs(d - depth), zero))
    if rec["stage"] == "color":
        cc = torch.clamp(c, 1.0 / 510.0, 1.0 - 1.0 / 510.0)
        loss = loss + o["w_color_loss"] * torch.sum(
            torch.where(m[:, None], torch.abs(cc - color), zero))
    grads = torch.autograd.grad(loss, [P[k] for k in trained] + [feats],
                                allow_unused=True)
    out = {k: (torch.zeros_like(P[k]) if g is None else g)
           for k, g in zip(trained, grads[:-1])}
    return loss.detach(), out, grads[-1]


def adam_step(params: List[torch.Tensor], grads: List[Optional[torch.Tensor]],
              m: List[torch.Tensor], v: List[torch.Tensor], step: int,
              start, lrs, dt=torch.float32, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step (torch.optim.Adam's defaults; a missing gradient
    counts as zero; `start`: per leaf, the step its bias correction counts
    from, an int or a tensor per entry). Returns the new parameters."""
    step = step + 1
    start = start if start is not None else [0] * len(params)
    out = []
    for p, g, m_, v_, lr, s in zip(params, grads, m, v, lrs, start):
        p, m_, v_ = p.to(dt), m_.to(dt), v_.to(dt)
        g = torch.zeros_like(p) if g is None else g.to(dt)
        t = step - s
        if isinstance(t, torch.Tensor):
            t = t.to(torch.float32)
            c1 = 1.0 - torch.pow(torch.tensor(b1, device=t.device), t)
            c2 = 1.0 - torch.pow(torch.tensor(b2, device=t.device), t)
            c1, c2 = c1.to(dt), c2.to(dt)
        else:  # in float32 on the host, as the program computes them
            t = np.float32(t)
            c1 = float(np.float32(1.0) - np.float32(b1) ** t)
            c2 = float(np.float32(1.0) - np.float32(b2) ** t)
        lr = lr.to(dt) if isinstance(lr, torch.Tensor) else lr
        m1 = b1 * m_ + (1 - b1) * g
        v1 = b2 * v_ + (1 - b2) * g * g
        out.append(p - lr * (m1 / c1) / (torch.sqrt(v1 / c2) + eps))
    return out
