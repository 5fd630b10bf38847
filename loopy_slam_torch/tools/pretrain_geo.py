"""Pretrain the geometry decoder trunk on procedural rooms (port of
loopy_slam_tpu/tools/pretrain_geo.py).

The reference keeps NICE-SLAM's pretrained geometry decoder frozen during
SLAM (mapping.fix_geo_decoder). This tool makes the equivalent: on each of
`n_scenes` procedural rooms (box corners drawn from
np.random.default_rng(seed)) it inserts 3000 rays of every second frame,
then runs ONE optimize_map call with the geometry trunk unfrozen:
iters // 2 geometry and iters // 2 color iterations at 400 pixels a frame,
one Adam state from a fresh start (its step count threaded through both
stages, as the JAX tool's call does). The trunk carries on from scene to
scene. The result is the geometry trunk as a pickle of numpy arrays in the
JAX layout (`pretrained/geo_decoder.pkl`'s), which
`pretrained_decoders.middle_fine` loads in either package.

Random draws come from a draw object (ops/draws.py): a seeded
TorchDraws by default, or the draws another implementation made
(ReplayDraws). `init_params` starts from a given decoder pytree of numpy
arrays instead of a random init.

CLI: python -m loopy_slam_torch.tools.pretrain_geo --out PATH
         [--scenes 4] [--iters 400] [--seed 7] [--device cuda|cpu]
(the default --out is pretrained/geo_decoder.pkl, the shipped trunk:
point it elsewhere unless you mean to replace that file)
"""

from __future__ import annotations

import argparse
import copy
import os
import pickle
import time

import numpy as np
import torch

# the JAX tool's overlay of DEFAULTS: a small camera, 8 frames, a 2^16
# buffer, no probe and no dynamic radius, the geometry trunk trainable
OVERLAY = {
    "dataset": "synthetic", "use_dynamic_radius": False,
    "cam": {"H": 120, "W": 160, "fx": 120.0, "fy": 120.0,
            "cx": 79.5, "cy": 59.5, "crop_edge": 0},
    "data": {"n_frames": 8},
    "rendering": {"sample_near_pcl": False},
    "mapping": {"fix_geo_decoder": False},
    "pointcloud": {"capacity": 2 ** 16, "cell_table_size": 2 ** 17},
}
ADD_RAYS = 3000
PIXELS = 400
LRS_GEO = (0.001, 0.03, 0.0)
LRS_COL = (0.001, 0.005, 0.005)


def pretrain_config():
    """DEFAULTS with the tool's overlay."""
    from ..config import DEFAULTS, update_recursive

    cfg = copy.deepcopy(DEFAULTS)
    update_recursive(cfg, copy.deepcopy(OVERLAY))
    return cfg


def scene_configs(cfg, n_scenes: int, seed: int):
    """Each scene's config: the room's box corners drawn in turn from
    np.random.default_rng(seed), as the JAX tool draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_scenes):
        scfg = copy.deepcopy(cfg)
        scfg["data"]["box_lo"] = (-rng.uniform(1.2, 2.5, 3)).tolist()
        scfg["data"]["box_hi"] = rng.uniform(1.2, 2.5, 3).tolist()
        out.append(scfg)
    return out


def map_scene(scfg, draw, device):
    """The scene's map from every second frame (ADD_RAYS rays each) and
    its keyframes stacked: (state, colors, depths, poses)."""
    from ..mapping.mapper import MapperOptions, add_points_from_frame
    from ..mapping.point_cloud import MapOptions, init_map
    from ..utils.datasets import Synthetic

    mopts_map = MapOptions.from_cfg(scfg)
    mopts = MapperOptions.from_cfg(scfg)
    ds = Synthetic(scfg)
    state = init_map(mopts_map, device=device)
    frames = []
    for i in range(0, scfg["data"]["n_frames"], 2):
        _, c, d, p = ds[i]
        c, d, p = (torch.as_tensor(np.asarray(a, np.float32), device=device)
                   for a in (c, d, p))
        frames.append((c, d, p))
        state, _ = add_points_from_frame(state, c, d, p, p, draw, mopts_map,
                                         mopts, ADD_RAYS, overlap=None)
    kc, kd, kp = (torch.stack(x) for x in zip(*frames))
    return state, kc, kd, kp


def pretrain(n_scenes: int = 4, iters: int = 400, seed: int = 7,
             verbose: bool = True, device=None, draw=None,
             init_params=None):
    """Train the trunk over n_scenes rooms. Returns (geo, scenes): the
    geometry trunk as a numpy pytree in the JAX layout, and per scene
    {"geo_loss_pixel", "color_loss_pixel", "rays", "points", "seconds"}
    (the last iteration's loss terms over its rays)."""
    from .. import resolve_device
    from ..convert import decoders_from_numpy, decoders_to_numpy
    from ..mapping.mapper import MapperOptions, optimize_map
    from ..mapping.point_cloud import valid_mask
    from ..models.decoder import init_decoders, trainable_mask
    from ..models.renderer import RenderOptions
    from ..ops.draws import TorchDraws

    dev = resolve_device(device)
    cfg = pretrain_config()
    bf16 = cfg["model"].get("bf16_trunks", True)
    if init_params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        dec = init_decoders(gen, cfg, device=dev)
    else:
        dec = decoders_from_numpy(init_params, dev, bf16_trunks=bf16)
    draw = draw if draw is not None else TorchDraws(seed, dev)
    dec_mask = trainable_mask(dec, cfg)  # the geometry trunk trains here
    mopts = MapperOptions.from_cfg(cfg)
    ropts = RenderOptions.from_cfg(cfg)
    scenes = []
    for s, scfg in enumerate(scene_configs(cfg, n_scenes, seed)):
        t0 = time.perf_counter()
        state, kc, kd, kp = map_scene(scfg, draw, dev)
        # Adam starts afresh each scene; the trunk carries on
        _, _, aux = optimize_map(
            dec, state.feat, None, dec_mask, valid_mask(state), state.pos,
            state.grid, kc, kd, kp, draw, iters // 2, iters // 2,
            list(LRS_GEO), list(LRS_COL), mopts, ropts, PIXELS)
        g, c, n = torch.stack(list(aux)).tolist()
        rec = {"geo_loss_pixel": g / max(n, 1),
               "color_loss_pixel": c / max(n, 1), "rays": int(n),
               "points": int(state.count),
               "seconds": time.perf_counter() - t0}
        scenes.append(rec)
        if verbose:
            print(f"scene {s}: geo/px {rec['geo_loss_pixel']:.4f} "
                  f"col/px {rec['color_loss_pixel']:.4f}", flush=True)
    return decoders_to_numpy(dec)["geo"], scenes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default="pretrained/geo_decoder.pkl")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    geo, scenes = pretrain(args.scenes, args.iters, args.seed,
                           device=args.device)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(geo, f)
    print(f"saved pretrained geometry decoder -> {args.out}")
    return geo, scenes


if __name__ == "__main__":
    main()
