"""The benchmark's own counts against the program's today, on the CPU: the
model-FLOP count against `LoopySLAM.roofline()`'s products of a tiny
session, and the frozen k-NN bound against `ops/knn.query_cost`."""

import copy
import os

import pytest
import torch

import tiny
from bench_core import flops
from bench_core.harness import load_cell, update_recursive

from loopy_slam_torch.ops import knn


@pytest.mark.parametrize("per_query", [False, True])
def test_knn_query_cost_equals_programs(per_query):
    g = torch.Generator().manual_seed(0)
    pts = torch.rand(5000, 3, generator=g)
    q = torch.rand(700, 3, generator=g)
    grid = knn.build(pts, torch.ones(5000, dtype=torch.bool), 0.1, 4096, 32)
    ours = flops.knn_query_cost(grid.cell_data, grid.cell_size,
                                grid.cell_fill, q, 8, per_query)
    assert ours == knn.query_cost(grid, q, 8, per_query)


def test_sample_macs_of_the_widths():
    c = load_cell("replica-room0.steady")["config"]
    m = flops.sample_macs(c["widths"], c["resolved"])
    assert (m["geo"], m["col"], m["neigh"]) == (15200, 96640, 86016)
    t = load_cell("tum-fr1-desk.steady")["config"]
    assert flops.sample_macs(t["widths"], t["resolved"])["neigh"] == 0


@pytest.mark.parametrize("cell", ["replica-room0.steady",
                                  "tum-fr1-desk.steady"])
def test_model_flops_match_the_programs_products(cell, tmp_path):
    """A tiny session's roofline() counts the products of one tracked
    frame and of one mapped frame. The model count leaves out what the
    configuration does not ask for: the frozen geometry trunk's weight
    gradients, which the mapper computes (it asks autograd for every
    decoder parameter and masks the frozen ones after). Those added, the
    two agree within 0.5%: the rest are the rays' 3x3 rotations and the
    Adam-free bookkeeping the model count does not hold."""
    from loopy_slam_torch.slam import LoopySLAM

    from bench_core.sequence import write_sequence

    c = load_cell(cell)
    cfg = copy.deepcopy(c["config"]["resolved"])
    update_recursive(cfg, tiny.overrides(c["conf"]["name"]))
    update_recursive(cfg, {"mapping": {"segment_strategy": "none",
                                       "every_frame": 3, "iters": 24,
                                       "device_chunk_iters": 4,
                                       "color_refine": False},
                           "data": {"input_folder": str(tmp_path / "seq"),
                                    "output": str(tmp_path / "out")}})
    cfg["pretrained_decoders"]["middle_fine"] = os.path.join(
        tiny.REPO, cfg["pretrained_decoders"]["middle_fine"])
    write_sequence(cfg["dataset"], str(tmp_path / "seq"), cfg["cam"], 7,
                   c["traffic"]["motion_speed"], 0.1, [5], workers=1)
    slam = LoopySLAM(cfg, device="cpu")
    slam.run()
    roof = slam.roofline()
    slam.close()
    w, R = c["config"]["widths"], cfg["tracking"]["pixels"]
    track = cfg["tracking"]["iters"] * flops.iteration_flops(
        "track", R, w, cfg)
    assert abs(roof["track"]["products"] / track - 1) < 5e-3
    kept = slam._roofline_calls["map"]["chunks"]["geo"]
    rays = kept["args"][6].shape[0] * kept["tail"][-1]
    m = roof["map"]
    frozen = (2 * flops.sample_macs(w, cfg)["geo"] * rays
              * cfg["rendering"]["N_surface"])
    model = (m["n_geo"] * flops.iteration_flops("geometry", rays, w, cfg)
             + m["n_col"] * flops.iteration_flops("color", rays, w, cfg))
    program = model + (m["n_geo"] + m["n_col"]) * frozen
    assert abs(m["products"] / program - 1) < 5e-3
