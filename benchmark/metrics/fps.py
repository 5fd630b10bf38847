"""fps: frames completed in the window over the window's wall time (data
wait, upload, tracking, mapping: all the work over all the time)."""


def read(run):
    return run.frames / run.window_s
