"""device_idle: the share of the profiled part's wall time in which no
operation ran on the device (the union of the trace's kernels, copies and
sets)."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
