"""frame_s.p90: the 90th percentile, over every frame of the window, of the
frame's own wall time, from the end of the frame before (its data fetch
on) to the end of its mapping when one is due."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.frame_s, np.float64), 90))
