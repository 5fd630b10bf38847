"""Kernel launches and host waits of the port's tracking and mapping
iterations on the card, read from torch.profiler inside the port's own
spans (utils/telemetry.py's detail level).

    python scripts/track_launches.py --cell tum-fr1-desk.steady

Runs the benchmark cell's configuration on its recording (written by the
benchmark's generator into benchmark/_cache/ unless it is there) for a
few frames. It profiles `--iters` iterations of the tracked frame
`--track-frame` and of the mapped frame `--map-frame`, from the close of
their iteration `--from-iter` (past the tracker's warm-up blocks). It
prints one JSON line: per tracking iteration (the
`track.iter` spans) and per mapping iteration (`map.iter`), the mean
count of kernel launches on the host (cudaLaunchKernel and the like),
split by the `*.fwd` / `*.bwd` / `*.adam` spans, the mean count of
`aten::_local_scalar_dense` calls (a device value read on the host) inside
the fwd and bwd spans, and the copies launched there (cudaMemcpy*) by the
aten op that issued them, with the card's name and power limit. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
          "cuLaunchKernelEx")


def _intervals(events, name):
    """The host's spans of that name, sorted (the profiler also lists each
    annotation on the device's timeline)."""
    return sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.name == name and e.device_type.name == "CPU")


def _counter(intervals):
    """t -> whether t lies in one of the sorted, disjoint intervals."""
    starts = [a for a, _ in intervals]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= intervals[i][1]
    return inside


def _origin(e):
    """The outermost aten op above a runtime call (what issued it)."""
    name, p = e.name, e.cpu_parent
    while p is not None:
        if p.name.startswith("aten::"):
            name = p.name
        p = p.cpu_parent
    return name


def count(events, prefix):
    """Per `<prefix>.iter`: launches in all and in each of its phases; in
    fwd / bwd, the host reads an iteration and the copies (cudaMemcpy*) by
    the aten op that issued them."""
    iters = _intervals(events, f"{prefix}.iter")
    in_iter = _counter(iters)
    phases = {p: _counter(_intervals(events, f"{prefix}.{p}"))
              for p in ("fwd", "bwd", "adam")}
    launches = [e.time_range.start for e in events if e.name in LAUNCH]
    n = max(len(iters), 1)
    out = {"iterations": len(iters),
           "launches_per_iter": sum(map(in_iter, launches)) / n}
    for p, inside in phases.items():
        out[f"{p}_launches_per_iter"] = sum(map(inside, launches)) / n

    def fwd_bwd(t):
        return phases["fwd"](t) or phases["bwd"](t)
    out["host_reads_per_iter_fwd_bwd"] = sum(
        fwd_bwd(e.time_range.start) for e in events
        if e.name == "aten::_local_scalar_dense") / n
    copies = {}
    for e in events:
        if (e.name.startswith("cudaMemcpy") or e.name.startswith("cuMemcpy")) \
                and fwd_bwd(e.time_range.start):
            k = _origin(e)
            copies[k] = copies.get(k, 0) + 1
    out["copies_per_iter_fwd_bwd"] = {k: v / n for k, v in copies.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--sequence", type=int, default=0,
                    help="which of the cell's recordings")
    ap.add_argument("--track-frame", type=int, default=3)
    ap.add_argument("--map-frame", type=int, default=4)
    ap.add_argument("--from-iter", type=int, default=20,
                    help="profile from the close of this iteration")
    ap.add_argument("--iters", type=int, default=10,
                    help="iterations profiled in each part")
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, os.path.join(HERE, "benchmark")]
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench_core.harness import load_cell, prepare_sequence
    from loopy_slam_torch.slam import LoopySLAM

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    c = load_cell(args.cell)
    cfg = c["config"]["resolved"]
    seq = prepare_sequence(c, cfg, args.sequence,
                           max(1, (os.cpu_count() or 2) - 1))
    tmp = tempfile.mkdtemp(prefix="track_launches_")
    cfg["data"].update(input_folder=seq, output=os.path.join(tmp, "out"),
                       n_frames=max(args.track_frame, args.map_frame) + 1)
    cfg["setup_seed"] = args.seed
    pre = cfg.get("pretrained_decoders", {}).get("middle_fine")
    if pre:
        cfg["pretrained_decoders"]["middle_fine"] = os.path.join(HERE, pre)
    slam = LoopySLAM(cfg, device="cuda")
    state = {"prof": None, "parts": {}}

    def start(part):
        torch.cuda.synchronize()
        state["prof"] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
        state["prof"].__enter__()
        state["part"] = part

    def stop():
        torch.cuda.synchronize()
        prof = state["prof"]
        prof.__exit__(None, None, None)
        state["parts"][state["part"]] = count(prof.events(), state["part"])
        state["prof"] = None

    def hook(name, attrs):
        frame = slam.tracer.frame
        part = {"track.iter": "track", "map.iter": "map"}.get(name)
        wanted = {"track": args.track_frame, "map": args.map_frame}
        if part is None or frame != wanted[part]:
            return
        if state["prof"] is None and part not in state["parts"] \
                and attrs.get("it", 0) >= args.from_iter:
            start(part)
            state["iters"] = 0
        elif state["prof"] is not None and state["part"] == part:
            state["iters"] += 1
            if state["iters"] == args.iters:
                stop()

    slam.tracer.enable(hook=hook)
    slam.run()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"cell": args.cell, "card": smi,
                      "torch": torch.__version__, **state["parts"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
