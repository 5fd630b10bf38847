"""The controls on the card, at each cell's own size, must come out as not
correct while the program's own numbers of the same run stay within their
limits: the reference computed in bfloat16 in the program's place, the
frame before in place of the frame the loaders should hand over, and a
step whose result is dropped. A short window (one mapping cycle) at the
cell's own load; three seeds a cell. Prints both readings of every
number.

    python -m pytest -m cuda -s benchmark/tests/test_bench_control_card.py
"""

import time

import pytest

import tiny  # noqa: F401  (puts the repo and the benchmark on sys.path)
from bench_core.harness import run_cell

CELLS = ["replica-room0.steady", "tum-fr1-desk.steady"]
SEEDS = [2900000011, 2900000027, 2900000041]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cells' sizes on a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell, seed):
    out = run_cell(cell, seed, 1.0, False, time.perf_counter(),
                   control=True)
    line = " ".join(f"{k}={v['value']!r}/{out['control'][k]!r}"
                    f"<={v['limit']!r}" for k, v in out["checks"].items())
    print(f"\ncontrol {cell} seed {seed}: {line}")
    assert out["correct"]

    def fails(names):
        return any(out["control"][k] is None
                   or out["control"][k] > out["checks"][k]["limit"]
                   for k in names)
    # the bfloat16 reference, the frame before, a step's result dropped
    assert fails(("knn_gap", "track_loss_gap", "track_grad_gap",
                  "map_loss_gap", "map_grad_gap", "adam_gap"))
    assert fails(("depth_gap", "color_gap"))
    assert fails(("chain_gap",))
