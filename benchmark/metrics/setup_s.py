"""setup_s: process start to the window's start: imports, the sequence
(written, or found in the cache), the kernel builds, the session's
construction and the warm-up frames."""


def read(run):
    return run.setup_s
