"""The harness on the CPU at a tiny size: a sound run is correct, loads
nothing of JAX, and counts by the configuration's schedule the iterations
that ran; a cell, configuration, mix and metric added as files in a fresh
directory run with no edit to the harness; and with the timed path broken
underneath (a step that leaves the state unchanged, half of the batch left
out with the loss scaled back up, a neighbour id altered where the k-NN
produces it, a step whose result the caller drops, the loaders handing over
the frame before or the colour channels swapped) `correct` comes out false.

The CPU path is the harness's `run_cell(device="cpu", cfg_overrides=...)`;
`run.py` itself refuses to run without a card. At the tiny size a JPEG
loses more to its 8x8 blocks (3.7 levels of 255 in the mean, against
0.8-0.9 at 680x1200), so these runs hold `color_gap` to TINY_LIMITS.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

import tiny
from bench_core.harness import run_cell

CELL, CONF = "replica-room0.steady", "replica-room0"
SEED = 3456789012345
TINY_LIMITS = {"color_gap": 6.0}


def _run(tmp_path):
    return run_cell(CELL, SEED, 1.0, False, time.perf_counter(),
                    device="cpu", cfg_overrides=tiny.overrides(CONF),
                    workers=2, cache_root=str(tmp_path.parent / "cache"),
                    limits=TINY_LIMITS)


def test_sound_run_is_correct_and_loads_no_jax(tmp_path):
    script = tmp_path / "dry.py"
    script.write_text(
        "import sys, time, json\n"
        f"sys.path[:0] = [{tiny.REPO!r}, {tiny.BENCH!r}, "
        f"{os.path.join(tiny.BENCH, 'tests')!r}]\n"
        "import tiny\n"
        "from bench_core.harness import run_cell, forbidden_modules\n"
        "if __name__ == '__main__':\n"
        f"    out = run_cell({CELL!r}, {SEED}, 1.0, True, time.perf_counter(),"
        f" device='cpu', cfg_overrides=tiny.overrides({CONF!r}),"
        f" workers=2, cache_root={str(tmp_path / 'cache')!r},"
        f" limits={TINY_LIMITS!r})\n"
        "    print(json.dumps({'out': out, 'forbidden': forbidden_modules(),"
        " 'modules': sorted({m.split('.')[0] for m in sys.modules})}))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "loopy_slam_tpu"} & set(
        res["modules"])
    assert "loopy_slam_torch" in res["modules"]
    out = res["out"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 5
    assert set(out["metrics"]) >= {"host_ms.frame", "data_wait_ms.frame",
                                   "track_ms.iter", "map_ms.iter", "mfu"}
    assert list(out)[-1] == "checks"
    # the schedule's count equals the count at the program's entry points
    m = re.search(r"track iters (\d+), map iters (\d+) by the schedule "
                  r"\((\d+) and (\d+) at the entry points\)", proc.stderr)
    assert m and m[1] == m[3] and m[2] == m[4] and int(m[2]) > 0, \
        proc.stderr[-3000:]


def test_new_cell_from_files_alone(tmp_path):
    """A throwaway configuration, mix, cell and metric, written as files of
    a fresh directory, run through the harness as it stands."""
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics"):
        (bench / sub).mkdir(parents=True)
    with open(os.path.join(tiny.BENCH, "configs", f"{CONF}.json")) as f:
        conf = json.load(f)
    from bench_core.harness import update_recursive

    update_recursive(conf["resolved"], tiny.overrides(CONF))
    conf["limits"].update(TINY_LIMITS)
    (bench / "configs" / "throwaway-room.json").write_text(json.dumps(conf))
    (bench / "traffic" / "brisk.json").write_text(json.dumps(
        {"motion_speed": 0.002, "scene": "v3", "frames": 40,
         "jpeg_quality": 90,
         "sequences": [{"phase": 0.3, "sensor_seed": 5}]}))
    for name in ("fps", "frame_s.p90", "setup_s"):
        shutil.copy(os.path.join(tiny.BENCH, "metrics", f"{name}.py"),
                    bench / "metrics")
    (bench / "metrics" / "frames.window.py").write_text(
        "def read(run):\n    return run.frames\n")
    spec = {"command": ["python3", "benchmark/run.py"],
            "paths": ["benchmark"], "run_seconds": 1,
            "configs": [{"name": "throwaway-room", "source": "a test",
                         "file": "benchmark/configs/throwaway-room.json",
                         "reduced": [], "why": "a test"}],
            "workloads": [{"name": "throwaway-room.brisk",
                           "config": "throwaway-room", "traffic": "brisk",
                           "chips": 1, "why": "a test"}],
            "end_to_end": [
                {"name": n, "unit": "s", "better": "lower", "bound": 0.25,
                 "source": "host_clock"}
                for n in ("fps", "frame_s.p90", "setup_s",
                          "frames.window")],
            "per_layer": []}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run_cell("throwaway-room.brisk", 11, 1.0, False,
                   time.perf_counter(), device="cpu", workers=2,
                   spec_path=str(tmp_path / "BENCHMARK.json"))
    assert out["correct"]
    assert out["metrics"]["frames.window"]["value"] == out["attempted"]
    assert os.path.isdir(bench / "_cache" / "throwaway-room.brisk")


class _DropsResult:
    """The optimizer module as a caller that drops the step's result sees
    it: the step runs (through whatever wraps it) and the caller goes on
    from the parameters it had."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def update(self, params, *a, **kw):
        _, st = self._mod.update(params, *a, **kw)
        return [p.clone() for p in params], st


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered", "result_dropped",
                                   "frame_before", "channels_swapped"])
def test_broken_timed_path_is_not_correct(fault, tmp_path, monkeypatch):
    """Each fault is patched into the program's module under the harness's
    own wrappers, so the run reads the broken call's outputs; a dropped
    result is patched into the callers of the optimizer, above them, and
    the loaders' faults into the dataset the prefetch thread reads."""
    from loopy_slam_torch.mapping import mapper, tracker
    from loopy_slam_torch.ops import adam, knn
    from loopy_slam_torch.utils import datasets

    if fault == "result_dropped":
        monkeypatch.setattr(tracker, "adam", _DropsResult(adam))
        monkeypatch.setattr(mapper, "adam", _DropsResult(adam))
    elif fault in ("frame_before", "channels_swapped"):
        getitem = datasets.BaseDataset.__getitem__

        def loaded(self, index):
            if fault == "channels_swapped":
                i, color, depth, pose = getitem(self, index)
                return i, color[..., ::-1].copy(), depth, pose
            _, color, depth, _ = getitem(self, max(index - 1, 0))
            return index, color, depth, getitem(self, index)[3]

        monkeypatch.setattr(datasets.BaseDataset, "__getitem__", loaded)
    elif fault == "state_unchanged":
        update = adam.update

        def unchanged(params, *a, **kw):
            new, st = update(params, *a, **kw)
            return [p.clone() for p in params], st

        monkeypatch.setattr(adam, "update", unchanged)
    elif fault == "answer_altered":
        query = knn.query_chunked

        def altered(*a, **kw):
            D, I, nn = query(*a, **kw)
            return D, torch.roll(I, 1, dims=0), nn

        monkeypatch.setattr(knn, "query_chunked", altered)
    else:
        t_orig, m_orig = tracker._loss_from_render, mapper._loss_terms

        def t_half(d, c, inside, depth, var, color, opts):
            n = d.shape[0] // 2
            loss, aux = t_orig(d[:n], c[:n], inside[:n], depth[:n],
                               var[:n], color[:n], opts)
            return 2 * loss, aux

        def m_half(d, c, inside, valid_ray, depth, color, stage, opts,
                   *a, **kw):
            n = d.shape[0] // 2
            loss, aux = m_orig(d[:n], c[:n], inside[:n], valid_ray[:n],
                               depth[:n], color[:n], stage, opts, *a, **kw)
            return 2 * loss, aux

        monkeypatch.setattr(tracker, "_loss_from_render", t_half)
        monkeypatch.setattr(mapper, "_loss_terms", m_half)
    out = _run(tmp_path)
    assert not out["correct"], out["checks"]
