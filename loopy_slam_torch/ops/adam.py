"""Functional Adam over lists of tensors with per-leaf learning rates
(port of loopy_slam_tpu/ops/adam.py).

Not torch.optim.Adam: that skips parameters whose grad is None, while the
reference step treats a missing gradient as zero and still decays m and v.
Matches torch.optim.Adam's defaults otherwise: betas (0.9, 0.999),
eps 1e-8, bias correction from a step count that persists across calls.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch


class AdamState(NamedTuple):
    m: List[torch.Tensor]
    v: List[torch.Tensor]
    step: int  # host integer: the schedule is known on the host


def init(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(m=[torch.zeros_like(p) for p in params],
                     v=[torch.zeros_like(p) for p in params], step=0)


LR = Union[float, torch.Tensor]


def update(params: Sequence[torch.Tensor],
           grads: Sequence[Optional[torch.Tensor]], state: AdamState,
           lr: Union[LR, Sequence[LR]], b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step. `lr` is one value for every leaf, or one per leaf (a
    float, or a tensor that broadcasts against the leaf, e.g. per-column
    rates). A None grad counts as zero. Returns (new_params, new_state);
    the inputs are not modified."""
    step = state.step + 1
    # bias corrections in float32, as the reference computes them on device
    t = np.float32(step)
    c1 = float(np.float32(1.0) - np.float32(b1) ** t)
    c2 = float(np.float32(1.0) - np.float32(b2) ** t)
    lrs = list(lr) if isinstance(lr, (list, tuple)) else [lr] * len(params)
    new_p, new_m, new_v = [], [], []
    for p, g, m_, v_, l in zip(params, grads, state.m, state.v, lrs):
        if g is None:
            g = torch.zeros_like(p)
        m = b1 * m_ + (1 - b1) * g
        v = b2 * v_ + (1 - b2) * g * g
        new_p.append(p - l * (m / c1) / (torch.sqrt(v / c2) + eps))
        new_m.append(m)
        new_v.append(v)
    return new_p, AdamState(m=new_m, v=new_v, step=step)
