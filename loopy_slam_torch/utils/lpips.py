"""LPIPS (AlexNet variant) in torch, on the device.

Port of loopy_slam_tpu/utils/lpips.py: the AlexNet feature trunk with the
LPIPS linear heads, over a weight bundle in `.npz` form (the repo ships
`pretrained/lpips_alex_randfeat.npz`; `scripts/convert_lpips_weights.py`
makes one from a torch `lpips` checkpoint). The convolutions are
`F.conv2d`, plain library calls: the JAX package has no Pallas kernel here.

Weight file format (npz keys):
    shift (3,), scale (3,)                 input normalization
    conv1_w (64,3,11,11),  conv1_b (64,)   stride 4, pad 2
    conv2_w (192,64,5,5),  conv2_b (192,)  pad 2       (maxpool 3/2 before)
    conv3_w (384,192,3,3), conv3_b (384,)  pad 1       (maxpool 3/2 before)
    conv4_w (256,384,3,3), conv4_b (256,)  pad 1
    conv5_w (256,256,3,3), conv5_b (256,)  pad 1
    lin1_w (64,), lin2_w (192,), lin3_w (384,), lin4_w (256,), lin5_w (256,)

Semantics (lpips v0.1, alex, spatial=False):
    x in [0,1] -> 2x-1 -> (x - shift)/scale; for each of the five relu
    outputs: unit-normalize along channels, squared difference between the
    two images, per-channel non-negative linear weight, spatial mean; the
    distance is the sum over the five layers.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

_CONV_SPECS = [  # (name, stride, pad, pool_before)
    ("conv1", 4, 2, False),
    ("conv2", 1, 2, True),
    ("conv3", 1, 1, True),
    ("conv4", 1, 1, False),
    ("conv5", 1, 1, False),
]

REQUIRED_KEYS = tuple(
    ["shift", "scale"]
    + [f"{n}_w" for n, *_ in _CONV_SPECS]
    + [f"{n}_b" for n, *_ in _CONV_SPECS]
    + [f"lin{i}_w" for i in range(1, 6)]
)


def load_lpips(weights_path: str, device=None) -> Dict[str, torch.Tensor]:
    """Load and validate an LPIPS-alex weight bundle onto `device` (the
    card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    data = np.load(weights_path)
    missing = [k for k in REQUIRED_KEYS if k not in data]
    if missing:
        raise ValueError(
            f"{weights_path} is not an LPIPS-alex bundle: missing {missing}"
            " (produce one with scripts/convert_lpips_weights.py)")
    return {k: torch.as_tensor(np.asarray(data[k], np.float32), device=device)
            for k in REQUIRED_KEYS}


def _alex_features(params, x):
    """x: (N,3,H,W) normalized input -> list of 5 relu feature maps."""
    feats = []
    for name, stride, pad, pool in _CONV_SPECS:
        if pool:
            x = F.max_pool2d(x, 3, 2)
        x = F.conv2d(x, params[f"{name}_w"], params[f"{name}_b"],
                     stride=stride, padding=pad)
        x = F.relu(x)
        feats.append(x)
    return feats


@torch.no_grad()
def lpips_pair(params, img: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """img/ref: (H,W,3) in [0,1] on the weights' device -> scalar LPIPS."""
    x = torch.stack([img, ref]).permute(0, 3, 1, 2)  # (2,3,H,W)
    x = 2.0 * x - 1.0
    x = (x - params["shift"][None, :, None, None]) \
        / params["scale"][None, :, None, None]
    dist = torch.zeros((), device=x.device)
    for i, f in enumerate(_alex_features(params, x)):
        norm = torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + 1e-10
        f = f / norm
        d2 = (f[0] - f[1]) ** 2                     # (C,h,w)
        w = params[f"lin{i + 1}_w"][:, None, None]
        dist = dist + torch.mean(torch.sum(d2 * w, dim=0))
    return dist


@functools.lru_cache(maxsize=2)
def _cached_params(weights_path: str, device: torch.device):
    return load_lpips(weights_path, device)


def lpips_alex(img: np.ndarray, ref: np.ndarray, weights_path: str,
               device=None) -> float:
    """LPIPS distance between two (H,W,3) images in [0,1], computed on
    `device` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    params = _cached_params(weights_path, device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=device)
    return float(lpips_pair(params, t(img), t(ref)))
