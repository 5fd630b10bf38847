"""host_ms.frame: per window frame, its wall time outside its track_frame
and map_frame spans (the host loop: the prefetch queue, the upload, the
bookkeeping between calls), as a mean in milliseconds. A traced run leaves
out the frame the profiler ran in."""


def read(run):
    out = [f - run.in_frame_s[i] for i, f in zip(run.frame_idx, run.frame_s)
           if i not in run.profiled_idx]
    return 1e3 * sum(out) / len(out) if out else None
