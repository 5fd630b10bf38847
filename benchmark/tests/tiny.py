"""Tiny overrides of the cells' configurations for the CPU tests: the
cameras cut by 10 and the budgets cut to seconds a frame. The timed sizes
run only on the card."""

import copy
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for p in (REPO, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

_COMMON = {
    "verbose": False,
    "tracking": {"pixels": 200, "iters": 6, "ignore_edge_W": 4,
                 "ignore_edge_H": 4, "vis_freq": 0},
    "mapping": {"pixels": 400, "pixels_adding": 800, "iters": 12,
                "iters_first": 30, "geo_iter_first": 10, "vis_freq": 0,
                "device_chunk_iters": 8, "save_ckpts": False,
                "pixels_based_on_color_grad": 100},
    "pointcloud": {"capacity": 32768, "cell_table_size": 65536},
}

TINY = {
    "replica-room0": {"cam": {"H": 68, "W": 120, "fx": 60.0, "fy": 60.0,
                              "cx": 59.5, "cy": 33.5}},
    "tum-fr1-desk": {"cam": {"H": 48, "W": 64, "fx": 51.73, "fy": 51.65,
                             "cx": 31.81, "cy": 25.48, "crop_edge": 1},
                     "tracking": {"pixels": 200, "iters": 6}},
}


def overrides(config: str):
    out = copy.deepcopy(_COMMON)
    for k, v in TINY[config].items():
        out.setdefault(k, {}).update(v) if isinstance(v, dict) else None
    return out
