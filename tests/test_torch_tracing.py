"""The port's tracer (utils/telemetry.py) in a tiny CPU session.

One session runs with the detail level off, one with it on (a hook and a
spans file); both run the same configuration from the same seed, so the
detail level must leave the trajectory, the map and the timings as they
are. A third, shorter run goes through the CLI with --spans.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from loopy_slam_torch import run as trun
from loopy_slam_torch.config import DEFAULTS, update_recursive
from loopy_slam_torch.slam import LoopySLAM
from loopy_slam_torch.utils import telemetry
from torch_cpu import torch_cpu  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOM = os.path.join(ROOT, "configs", "Synthetic", "room.yaml")
FIELDS = {"id", "name", "start_ns", "end_ns", "parent", "frame", "thread",
          "attrs"}


def _cfg(out, frames=5):
    cfg = copy.deepcopy(DEFAULTS)
    update_recursive(cfg, {
        "dataset": "synthetic", "use_dynamic_radius": False,
        "setup_seed": 1219, "verbose": False,
        "cam": {"H": 60, "W": 80, "fx": 60.0, "fy": 60.0, "cx": 39.5,
                "cy": 29.5, "png_depth_scale": 6553.5, "crop_edge": 0},
        "data": {"n_frames": frames, "output": str(out)},
        "tracking": {"pixels": 200, "iters": 5, "ignore_edge_W": 4,
                     "ignore_edge_H": 4, "vis_freq": 0},
        "mapping": {"every_frame": 2, "pixels": 400, "pixels_adding": 800,
                    "pixels_based_on_color_grad": 0, "iters": 20,
                    "iters_first": 24, "geo_iter_first": 10,
                    "mapping_window_size": 4, "keyframe_every": 2,
                    "color_refine": False, "segment_strategy": "none",
                    "device_chunk_iters": 8, "vis_freq": 0},
        "rendering": {"sample_near_pcl": False, "eval_img": False},
        "pointcloud": {"capacity": 2 ** 15, "cell_table_size": 2 ** 16,
                       "max_per_cell": 24, "radius_add": 0.08,
                       "radius_query": 0.16, "radius_min": 0.04},
        "meshing": {"eval_rec": False},
    })
    return cfg


def _schedule(cfg, idx, added_locations):
    """(n_geo, n_col) of a mapped frame, as map_frame works them out."""
    m = cfg["mapping"]
    if idx == 0:
        num = m["iters_first"]
        n_geo = min(m["geo_iter_first"] + 1, num)
    else:
        num = int(np.clip(m["iters"] * added_locations / 300,
                          int(m["min_iter_ratio"] * m["iters"]),
                          2 * m["iters"]))
        n_geo = min(int(num * m["geo_iter_ratio"]) + 1, num)
    return n_geo, num - n_geo


def _run(out, detail):
    """A session; with detail, the hook's calls and the spans file. The
    points each mapped frame added are read around its map_frame."""
    from torch_cpu import cpu_settings

    with cpu_settings():
        torch.manual_seed(0)
        slam = LoopySLAM(_cfg(out), device="cpu")
        hook_calls, path = [], str(out / "spans.jsonl")
        if detail:
            slam.tracer.enable(
                hook=lambda name, attrs: hook_calls.append((name, attrs)),
                path=path)
        added, map_frame = {}, slam.map_frame

        def counted(idx, *a, **kw):
            n0 = slam._count_host
            map_frame(idx, *a, **kw)
            added[idx] = (slam._count_host - n0) // slam.mopts_map.N_add

        slam.map_frame = counted
        slam.run()
        slam.close()
    spans = []
    if detail:
        with open(path) as f:
            spans = [json.loads(line) for line in f]
    return {"slam": slam, "spans": spans, "hook": hook_calls,
            "added": added}


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    return {"off": _run(tmp_path_factory.mktemp("trace_off"), False),
            "on": _run(tmp_path_factory.mktemp("trace_on"), True)}


def _children(spans, parent, name):
    return [s for s in spans if s["parent"] == parent["id"]
            and s["name"] == name]


def test_detail_off_records_no_spans_and_returns_the_shared_no_op(
        sessions):
    tr = sessions["off"]["slam"].tracer
    assert not tr.detail and tr.spans == []
    a, b = tr.span("track.iter", it=0), tr.span("map.iter", stage="color")
    assert a is b is telemetry.current().span("knn.query")
    # a phase span still times its block, and only a finished one
    got = []
    with tr.span("frame.data", record=got.append):
        pass
    with pytest.raises(KeyError):
        with tr.span("frame.data", record=got.append):
            raise KeyError
    assert len(got) == 1 and 0 <= got[0] < 1.0


def test_tracked_frames_run_their_iterations_with_children(sessions):
    spans = sessions["on"]["spans"]
    iters = sessions["on"]["slam"].topts.iters
    tracks = [s for s in spans if s["name"] == "track"]
    assert [s["frame"] for s in tracks] == [2, 3, 4]
    for t in tracks:
        its = _children(spans, t, "track.iter")
        assert [s["attrs"]["it"] for s in its] == list(range(iters))
        for it in its:
            for child in ("track.fwd", "track.bwd", "track.adam"):
                assert len(_children(spans, it, child)) == 1, child
        for name in ("track.keep", "track.pool", "track.gate",
                     "track.readback"):
            assert _children(spans, t, name), name


def test_mapped_frames_run_their_schedule(sessions):
    run = sessions["on"]
    spans, cfg = run["spans"], run["slam"].cfg
    maps = [s for s in spans if s["name"] == "map"]
    assert [s["frame"] for s in maps] == [0, 2, 4]
    for m in maps:
        idx = m["frame"]
        n_geo, n_col = _schedule(cfg, idx, run["added"][idx])
        chunks = _children(spans, m, "map.chunk")
        its = [it for c in chunks for it in _children(spans, c, "map.iter")]
        assert len(its) == n_geo + n_col
        assert sum(s["attrs"]["stage"] == "geometry" for s in its) == n_geo
        assert sum(c["attrs"]["iters"] for c in chunks) == n_geo + n_col
        assert all(len(_children(spans, c, "map.pool")) == 1 for c in chunks)
        for it in its:
            for child in ("map.fwd", "map.bwd", "map.adam"):
                assert len(_children(spans, it, child)) == 1, child
        inner = {s["name"] for s in spans if s["parent"] == m["id"]}
        assert {"map.insert", "map.window", "map.chunk", "map.writeback",
                "map.keyframe"} <= inner
    # a steady frame keeps its full chunks for roofline()
    assert any(s["name"] == "map.keep" and s["frame"] == 4 for s in spans)


def test_spans_nest_and_carry_their_frame(sessions):
    spans = sessions["on"]["spans"]
    assert all(set(s) == FIELDS for s in spans)
    by_id = {s["id"]: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        assert isinstance(s["frame"], int)
        if s["parent"] is None:
            assert s["name"] in ("frame", "loader.frame", "loader.put")
            continue
        p = by_id[s["parent"]]
        assert p["thread"] == s["thread"] and p["frame"] == s["frame"]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    frames = [s for s in spans if s["name"] == "frame"]
    assert [s["frame"] for s in frames] == list(range(5))
    assert all(s["attrs"] == {"idx": s["frame"]} for s in frames)
    for name in ("frame.data", "frame.upload"):
        assert sorted(s["frame"] for s in spans if s["name"] == name) \
            == list(range(5))
    loads = [s for s in spans if s["name"] == "loader.frame"]
    assert sorted(s["frame"] for s in loads) == list(range(5))
    assert {s["thread"] for s in loads} == {"loader"}
    assert all(s["thread"] == "MainThread" for s in spans
               if not s["name"].startswith("loader."))
    # every k-NN call of the session: the tracker's pools (one a warm-up
    # block) and the mapper's (one a chunk)
    assert any(by_id[s["parent"]]["name"] == "track.pool" for s in spans
               if s["name"] == "knn.query")
    assert any(by_id[s["parent"]]["name"] == "map.pool" for s in spans
               if s["name"] == "knn.query")
    assert all(s["attrs"]["q"] > 0 for s in spans
               if s["name"] == "knn.query")


def test_hook_fires_once_per_closed_span(sessions):
    run = sessions["on"]
    main = [s for s in run["spans"] if s["thread"] == "MainThread"]
    assert len(run["hook"]) == len(run["spans"])
    # the main thread's spans were written in the order they closed
    hooked = [c for c in run["hook"] if not c[0].startswith("loader.")]
    assert [(s["name"], s["attrs"]) for s in main] == hooked


def test_detail_level_leaves_the_session_bit_equal(sessions):
    off, on = sessions["off"]["slam"], sessions["on"]["slam"]
    np.testing.assert_array_equal(off.estimate_c2w, on.estimate_c2w)
    for name in ("pos", "feat", "count"):
        assert torch.equal(getattr(off.map_state, name),
                           getattr(on.map_state, name)), name
    for (n, p), (_, q) in zip(off.dec.named_parameters(),
                              on.dec.named_parameters()):
        assert torch.equal(p, q), n
    assert off.timings.keys() == on.timings.keys()
    assert {k: len(v) for k, v in off.timings.items()} \
        == {k: len(v) for k, v in on.timings.items()}
    assert len(on.timings["data"]) == 5 and len(on.timings["map"]) == 3
    # the spans file took them a frame at a time
    assert sessions["on"]["slam"].tracer.spans == []


def test_cli_spans_writes_one_json_line_a_span(tmp_path, torch_cpu):
    out, path = tmp_path / "out", tmp_path / "spans.jsonl"
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(
        f"inherit_from: {ROOM}\n"
        f"data: {{n_frames: 3, output: {out}}}\n"
        "cam: {H: 60, W: 80, fx: 60.0, fy: 60.0, cx: 39.5, cy: 29.5}\n"
        "tracking: {pixels: 200, iters: 3, vis_freq: 0}\n"
        "mapping: {every_frame: 2, pixels: 400, pixels_adding: 800,\n"
        "  iters: 10, iters_first: 12, geo_iter_first: 5,\n"
        "  color_refine: False, segment_strategy: none, vis_freq: 0}\n"
        "pointcloud: {capacity: 32768, cell_table_size: 65536}\n"
        "meshing: {eval_rec: False}\n"
        "rendering: {eval_img: False}\n")
    stats = trun.main([str(cfg), "--device", "cpu", "--spans", str(path)])
    assert stats["n"] == 3
    lines = path.read_text().splitlines()
    spans = [json.loads(line) for line in lines]
    assert spans and all(set(s) == FIELDS for s in spans)
    assert [s["frame"] for s in spans if s["name"] == "frame"] == [0, 1, 2]
    assert sum(s["name"] == "track.iter" for s in spans) == 3
