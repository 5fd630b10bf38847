"""loopy_slam_torch: the PyTorch + CUDA port of loopy_slam_tpu for one
NVIDIA H100.

The JAX package `loopy_slam_tpu` stays the reference; this package imports
nothing from it (and never imports jax). Entry points run on the card
unless the caller passes `device="cpu"`, which the parity tests do. On CPU
tensors every hand-written kernel falls back to its plain PyTorch version;
on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: `cuda` by default, and an error
    (not a silent CPU fallback) when no card is present.

    Also pins float32 matmuls and convolutions to full precision (no TF32)
    so the port's numbers follow the JAX reference's f32 arithmetic.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "loopy_slam_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev
