"""The benchmark of loopy_slam_torch on NVIDIA GPUs: one run of one cell.

    python3 benchmark/run.py --workload replica-room0.steady --seed 7 \
        --seconds 40 --trace 0

Runs from the root of a checkout. Writes the cell's sequence from the seed
(cached per cell under benchmark/_cache/), drives the program's own loop
over it, measures whole mapping cycles for `--seconds`, checks the
window's work against the plain reference, and prints one JSON object as
the last line of standard output: the end-to-end metrics with --trace 0,
the per-layer metrics (and the device's busy time and a breakdown) with
--trace 1. Exits non-zero, with no result, without a CUDA card or with
fewer cards than the cell asks for, and when JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(BENCH_DIR)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [REPO_DIR, BENCH_DIR]
    import torch

    import loopy_slam_torch  # noqa: F401  (the system under test)

    from bench_core.harness import forbidden_modules, load_cell, run_cell

    chips = int(load_cell(args.workload)["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print("no result: loaded " + ", ".join(found), file=sys.stderr)
        return 3
    checks = out.pop("checks")
    out["checks"] = checks  # the numbers compared, last in the line
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
