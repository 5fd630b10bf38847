"""Functional Adam over lists of tensors with per-leaf learning rates
(port of loopy_slam_tpu/ops/adam.py).

Not torch.optim.Adam: that skips parameters whose grad is None, while the
reference step treats a missing gradient as zero and still decays m and v.
Matches torch.optim.Adam's defaults otherwise: betas (0.9, 0.999),
eps 1e-8, bias correction from a step count that persists across calls.

`restart` gives chosen leaves (or columns of a leaf) a fresh start inside
a running state: zero moments and a bias correction counted from the next
step, as torch.optim.Adam treats a parameter whose first gradient comes
late. The reference has no such call.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch


class AdamState(NamedTuple):
    m: List[torch.Tensor]
    v: List[torch.Tensor]
    step: int  # host integer: the schedule is known on the host
    # per leaf, the step its count starts after: an int, or an int64
    # tensor that broadcasts against the leaf (per column); None: all 0
    start: Optional[List[Union[int, torch.Tensor]]] = None


def init(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(m=[torch.zeros_like(p) for p in params],
                     v=[torch.zeros_like(p) for p in params], step=0)


LR = Union[float, torch.Tensor]


def restart(state: AdamState, which) -> AdamState:
    """The state with some leaves started afresh. which: one entry per
    leaf, None or False (the leaf goes on), True (the whole leaf), or a
    bool tensor that broadcasts against the leaf (those entries, e.g.
    columns). Restarted entries get zero moments, and their bias
    correction counts from the next step."""
    start = list(state.start) if state.start is not None \
        else [0] * len(state.m)
    m, v = list(state.m), list(state.v)
    for i, w in enumerate(which):
        if w is None or w is False:
            continue
        if w is True:
            m[i] = torch.zeros_like(m[i])
            v[i] = torch.zeros_like(v[i])
            start[i] = state.step
            continue
        keep = (~w).to(m[i].dtype)
        m[i] = m[i] * keep
        v[i] = v[i] * keep
        start[i] = torch.where(w, state.step,
                               torch.as_tensor(start[i], device=w.device))
    return AdamState(m=m, v=v, step=state.step, start=start)


def _corrections(t, b1, b2):
    """1 - b1**t and 1 - b2**t in float32, as the reference computes them
    on device: Python floats for an integer t, tensors for a tensor."""
    if isinstance(t, torch.Tensor):
        t = t.to(torch.float32)
        return 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                            device=t.device), t), \
            1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=t.device), t)
    t = np.float32(t)
    return (float(np.float32(1.0) - np.float32(b1) ** t),
            float(np.float32(1.0) - np.float32(b2) ** t))


def update(params: Sequence[torch.Tensor],
           grads: Sequence[Optional[torch.Tensor]], state: AdamState,
           lr: Union[LR, Sequence[LR]], b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step. `lr` is one value for every leaf, or one per leaf (a
    float, or a tensor that broadcasts against the leaf, e.g. per-column
    rates). A None grad counts as zero. Returns (new_params, new_state);
    the inputs are not modified."""
    step = state.step + 1
    start = state.start if state.start is not None else [0] * len(params)
    lrs = list(lr) if isinstance(lr, (list, tuple)) else [lr] * len(params)
    new_p, new_m, new_v = [], [], []
    for p, g, m_, v_, l, s in zip(params, grads, state.m, state.v, lrs,
                                  start):
        if g is None:
            g = torch.zeros_like(p)
        c1, c2 = _corrections(step - s, b1, b2)
        m = b1 * m_ + (1 - b1) * g
        v = b2 * v_ + (1 - b2) * g * g
        new_p.append(p - l * (m / c1) / (torch.sqrt(v / c2) + eps))
        new_m.append(m)
        new_v.append(v)
    return new_p, AdamState(m=new_m, v=new_v, step=step, start=state.start)
