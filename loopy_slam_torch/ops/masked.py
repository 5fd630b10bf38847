"""Masked reductions for static-shape pipelines (port of
loopy_slam_tpu/ops/masked.py). Everything stays fixed-size with a validity
mask, and no reduction reads a value back to the host."""

from __future__ import annotations

import torch


def masked_sum(x, mask):
    return torch.sum(torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device)))


def masked_mean(x, mask):
    n = torch.clamp(torch.sum(mask), min=1)
    return masked_sum(x, mask) / n


def masked_max(x, mask, fill=-float("inf")):
    return torch.max(torch.where(
        mask, x, torch.full((), fill, dtype=x.dtype, device=x.device)))


def masked_median(x, mask):
    """Lower median of the masked-in entries of a 1-D tensor: the sorted
    value at index (count-1)//2, as torch.median returns for even counts.
    Invalid entries sort to +inf; an empty mask reads index 0."""
    x = torch.where(mask, x, torch.full((), float("inf"), dtype=x.dtype,
                                        device=x.device))
    xs = torch.sort(x).values
    count = torch.sum(mask)
    idx = torch.clamp(torch.div(count - 1, 2, rounding_mode="floor"), min=0)
    return xs.index_select(0, idx.reshape(1)).reshape(())
