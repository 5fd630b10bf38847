"""Random draws as an explicit input.

`jax.random` keys and torch generators give different numbers from the
same seed, so every port function that needs randomness takes a draw
object and asks it for `randint` and `normal` tensors in a fixed, documented
order. A session uses `TorchDraws` (one `torch.Generator` seeded from
`setup_seed`); parity tests use `ReplayDraws` to hand the port exactly the
draws the JAX package made.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import resolve_device


class TorchDraws:
    """Draws from one seeded `torch.Generator` on `device`."""

    def __init__(self, seed: int, device: torch.device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def randint(self, shape, lo: int, hi: int) -> torch.Tensor:
        """int64 uniform in [lo, hi)."""
        return torch.randint(int(lo), int(hi), tuple(shape),
                             generator=self.gen, device=self.device)

    def normal(self, shape) -> torch.Tensor:
        """float32 standard normal."""
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.device, dtype=torch.float32)


class ReplayDraws:
    """Hands out pre-made arrays in order, checking each request's shape
    (and for randint its range), so a test can feed the port the draws
    another implementation made."""

    def __init__(self, arrays: Sequence[np.ndarray], device=None):
        """device: the card unless the caller asks for the CPU."""
        self.items = list(arrays)
        self.device = resolve_device(device)

    def _next(self, shape):
        if not self.items:
            raise IndexError(f"no draw left for a request of shape {shape}")
        a = np.asarray(self.items.pop(0))
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"replayed draw has shape {a.shape}, the port "
                             f"asked for {tuple(shape)}")
        return a

    def randint(self, shape, lo: int, hi: int) -> torch.Tensor:
        a = self._next(shape)
        if a.size and (a.min() < lo or a.max() >= hi):
            raise ValueError(f"replayed draw outside [{lo}, {hi})")
        return torch.as_tensor(a.astype(np.int64), device=self.device)

    def normal(self, shape) -> torch.Tensor:
        return torch.as_tensor(self._next(shape).astype(np.float32),
                               device=self.device)
