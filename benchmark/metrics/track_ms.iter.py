"""track_ms.iter: the window's track_frame spans over the tracking
iterations they ran (tracking.iters a frame), in milliseconds. A traced
run leaves out the span the profiler ran in."""


def read(run):
    if not run.track_iters:
        return None
    return 1e3 * run.track_s / run.track_iters
