"""Timing and experiment-tracking instrumentation (port of
loopy_slam_tpu/utils/telemetry.py): a timer registry with per-phase
statistics, an optional torch.profiler trace, and a wandb shim that is a
no-op when wandb is off or not installed (cfg["wandb"] may be set either
way).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional


class Timers:
    def __init__(self):
        self.records: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        import numpy as np

        out = {}
        for k, v in self.records.items():
            a = np.asarray(v)
            out[k] = {"n": len(v), "mean_s": float(a.mean()),
                      "median_s": float(np.median(a)),
                      "total_s": float(a.sum())}
        return out

    def report(self):
        for k, s in sorted(self.summary().items()):
            print(f"  {k:24s} n={s['n']:<5d} median {s['median_s']*1e3:8.1f} ms"
                  f"  total {s['total_s']:8.2f} s")


GLOBAL_TIMERS = Timers()


class WandbLogger:
    """wandb.init/log/finish when cfg["wandb"] is set and wandb imports;
    otherwise `enabled` is False and every call does nothing."""

    def __init__(self, cfg, name: str):
        self.enabled = bool(cfg.get("wandb"))
        self.run = None
        if self.enabled:
            try:
                import wandb

                self.run = wandb.init(
                    project=cfg.get("project_name", "loopy_slam_torch"),
                    name=name, dir=cfg.get("wandb_folder", "output"),
                    config=cfg)
            except Exception as e:  # noqa: BLE001 - offline or not installed
                print(f"wandb disabled ({type(e).__name__}); "
                      "logging to console only")
                self.enabled = False

    def log(self, payload: dict):
        if self.enabled and self.run is not None:
            self.run.log(payload)

    def finish(self):
        if self.enabled and self.run is not None:
            self.run.finish()


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """A torch.profiler trace of the block (CPU and, with a card, CUDA
    activity), written as a Chrome trace into trace_dir; nothing without a
    directory."""
    if not trace_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
