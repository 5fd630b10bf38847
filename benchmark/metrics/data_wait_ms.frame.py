"""data_wait_ms.frame: the program's own timings["data"] (the wait on the
prefetch queue for a decoded frame) over the window's frames, as a mean
in milliseconds."""


def read(run):
    if not run.data_s:
        return None
    return 1e3 * sum(run.data_s) / len(run.data_s)
