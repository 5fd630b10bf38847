"""Timing and experiment-tracking instrumentation (port of
loopy_slam_tpu/utils/telemetry.py): the session's tracer and a wandb shim
that is a no-op when wandb is off or not installed (cfg["wandb"] may be
set either way).

The tracer (`Timers`) has two levels.

  * Phase level, always on: a span given `record` times its block with
    one pair of `time.perf_counter_ns` reads and hands the seconds to
    `record` when the block ends without an exception. The session's
    `timings`, `seg_timings` and the loop closer's `registration_times` /
    `pgo_times` are filled so. `time(name)` appends to `records[name]`
    whether or not the block raises (the JAX package's Timers:
    `records`, `summary`).
  * Detail level, off until `enable()`: every span is recorded (name,
    start and end in perf_counter_ns, id, parent id, frame index, thread
    name, attributes) and opens `torch.profiler.record_function(name)`,
    so that inside a profiled window it is a `user_annotation` on the
    same timeline as the CUDA kernels; the hook, if given, is called
    with (name, attrs) as each span closes; with a path, `flush()`
    appends the closed spans to it as JSON lines and drops them. While
    the level is off, a span without `record` is one shared no-op
    context.

Code below the session (tracker, mapper, k-NN) reaches the running
session's tracer through `current()`; outside `LoopySLAM.run` that is a
tracer that stays off.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Timed:
    """A phase span with the detail level off: its seconds to `record`."""

    __slots__ = ("record", "t0")

    def __init__(self, record):
        self.record = record

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.record((time.perf_counter_ns() - self.t0) * 1e-9)
        return False


class _Span:
    """A span with the detail level on."""

    __slots__ = ("tracer", "name", "record", "frame", "attrs", "id",
                 "parent", "annotation", "t0")

    def __init__(self, tracer, name, record, frame, attrs):
        self.tracer, self.name, self.record = tracer, name, record
        self.frame, self.attrs = frame, attrs

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(tr._ids)
        stack.append(self.id)
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        self.annotation.__exit__(exc_type, exc, tb)
        tr = self.tracer
        tr._stack().pop()
        rec = {"id": self.id, "name": self.name, "start_ns": self.t0,
               "end_ns": t1, "parent": self.parent, "frame": self.frame,
               "thread": threading.current_thread().name,
               "attrs": self.attrs}
        with tr._lock:
            tr.spans.append(rec)
        if self.record is not None and exc_type is None:
            self.record((t1 - self.t0) * 1e-9)
        if tr.hook is not None:
            tr.hook(self.name, self.attrs)
        return False


class Timers:
    def __init__(self):
        self.records: Dict[str, List[float]] = defaultdict(list)
        self.detail = False
        self.spans: List[Dict] = []
        self.hook: Optional[Callable[[str, Dict], None]] = None
        # the frame the session is on: every span opened meanwhile (and
        # not given a frame of its own) carries it
        self.frame: Optional[int] = None
        self._path: Optional[str] = None
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def enable(self, hook: Optional[Callable[[str, Dict], None]] = None,
               path: Optional[str] = None):
        """Turn the detail level on; hook(name, attrs) is called as each
        span closes; with a path, flush() writes the spans there (without
        one they stay in `spans` until the caller drops them)."""
        self.detail, self.hook, self._path = True, hook, path

    def span(self, name: str, record: Optional[Callable[[float], None]] =
             None, frame: Optional[int] = None, **attrs):
        """A context manager over one block of work. record(seconds) is
        called when the block ends without an exception, at either level;
        frame overrides the session's current frame (the prefetch thread
        works ahead of it)."""
        if not self.detail:
            return _NO_SPAN if record is None else _Timed(record)
        return _Span(self, name, record,
                     self.frame if frame is None else frame, attrs)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            with self.span(name):
                yield
        finally:
            self.records[name].append(time.perf_counter() - t0)

    def flush(self):
        """Append the closed spans to the path given to enable(), one JSON
        line a span, and drop them; nothing without a path."""
        if self._path is None:
            return
        with self._lock:
            spans, self.spans = self.spans, []
        if spans:
            with open(self._path, "a") as f:
                for s in spans:
                    f.write(json.dumps(s) + "\n")

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

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


_OFF = Timers()
_current = _OFF


def current() -> Timers:
    """The tracer of the session whose run() is on, else one that is
    off."""
    return _current


@contextlib.contextmanager
def active(tracer: Timers):
    """Make `tracer` the one current() returns inside the block."""
    global _current
    prev, _current = _current, tracer
    try:
        yield
    finally:
        _current = prev


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
