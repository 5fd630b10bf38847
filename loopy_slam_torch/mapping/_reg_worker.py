"""Spawn-pool worker entry for submap registration.

Port of loopy_slam_tpu/mapping/_reg_worker.py. It lives in its own module
so a spawned worker imports only numpy/scipy (ops/registration.py) and
the package's __init__, which imports torch but creates no CUDA context:
the workers never touch the card.
"""

import numpy as np

from ..ops import registration as reg


def register_one(args):
    s, t, s_seg, t_seg, method, global_iter, conf, seed = args
    return reg.register_point_cloud_pair(
        s, t, s_seg, t_seg, method, global_iter, conf,
        rng=np.random.default_rng(seed))
