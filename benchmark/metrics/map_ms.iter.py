"""map_ms.iter: the window's map_frame spans over the mapping iterations
they ran (the configuration's schedule of the points each frame added), in
milliseconds, point insertion and the window's set-up included."""


def read(run):
    if not run.map_iters:
        return None
    return 1e3 * run.map_s / run.map_iters
