"""Rendering-quality evaluation over saved renders (port of
loopy_slam_tpu/tools/eval_images.py): masked PSNR, MS-SSIM, depth L1 and,
with a weights bundle, LPIPS.

CLI: python -m loopy_slam_torch.tools.eval_images --renders DIR --config CFG
     [--device cuda|cpu]
Library: evaluate_renders(pairs) over (render, gt) arrays.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List, Tuple

import numpy as np

from ..utils.metrics import depth_l1, lpips, masked_psnr, ms_ssim


def evaluate_renders(pairs: List[Tuple[np.ndarray, np.ndarray,
                                       np.ndarray, np.ndarray]],
                     lpips_weights: str = None, device=None) -> Dict:
    """pairs: (rendered_color, gt_color, rendered_depth, gt_depth).

    lpips_weights: optional LPIPS-alex bundle path (rendering.lpips_weights);
    when given, 'lpips' is the metric, computed on `device` (the card
    unless the caller asks for the CPU), else None."""
    psnrs, ssims, d1s, lps = [], [], [], []
    for rc, gc, rd, gd in pairs:
        mask = gd > 0
        psnrs.append(masked_psnr(rc, gc, mask))
        ssims.append(ms_ssim(rc, gc))
        d1s.append(depth_l1(rd, gd))
        if lpips_weights is not None:
            lps.append(lpips(np.clip(rc, 0.0, 1.0), np.clip(gc, 0.0, 1.0),
                             lpips_weights, device))
    return {
        "psnr": float(np.mean(psnrs)) if psnrs else float("nan"),
        "ms_ssim": float(np.mean(ssims)) if ssims else float("nan"),
        "depth_l1": float(np.nanmean(d1s)) if d1s else float("nan"),
        "lpips": float(np.mean(lps)) if lps else None,
        "n_frames": len(pairs),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--renders", required=True,
                    help="dir with color_XXXXX.npy/depth_XXXXX.npy renders")
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device of LPIPS (default: the CUDA card)")
    args = ap.parse_args(argv)
    from ..config import load_config
    from ..utils.datasets import get_dataset

    cfg = load_config(args.config)
    ds = get_dataset(cfg)
    pairs = []
    for cpath in sorted(glob.glob(os.path.join(args.renders,
                                               "color_*.npy"))):
        idx = int(os.path.basename(cpath)[6:11])
        dpath = os.path.join(args.renders, f"depth_{idx:05d}.npy")
        _, gc, gd, _ = ds[idx]
        pairs.append((np.load(cpath), gc, np.load(dpath), gd))
    stats = evaluate_renders(pairs, cfg["rendering"].get("lpips_weights"),
                             args.device)
    print(stats)
    return stats


if __name__ == "__main__":
    main()
