"""The control: the reference put in the program's place, one precision
below the configuration's (fp8 for the bf16 eval cells, TF32 for the f32
train cell), and the half-batch fault read on the reference, must fail
the cell's limits. At 64x128 on the CPU here; at the cell's own size on
the card with ``-m chip``."""

import pytest
import torch

from perfbench import harness
from perfbench.tools import readings
from tiny import tiny_cell

CPU = torch.device("cpu")
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def _fails(nums, limits) -> bool:
    return any(not v <= limits[k] for k, v in nums.items())


@pytest.mark.parametrize("cell", ["dtu-serve", "tt-forward"])
def test_eval_control_fails(cell):
    c = tiny_cell(cell)
    assert _fails(readings.eval_control(c, SEEDS[0], CPU), c.limits)


@pytest.mark.parametrize("what", ["control", "half_batch"])
def test_train_control_fails(what):
    c = tiny_cell("dtu-train")
    nums, _ = readings.train_reading(c, SEEDS[0], CPU, what)
    assert _fails(nums, c.limits)


@pytest.mark.chip
@pytest.mark.parametrize("cell,what", [("dtu-serve", "control"), ("tt-forward", "control"),
                                       ("dtu-train", "control"), ("dtu-train", "half_batch")])
def test_control_fails_at_the_cells_size(card, cell, what):
    c = harness.load_cell(cell)
    for seed in SEEDS:
        nums = (readings.eval_control(c, seed, card) if what == "control"
                and cell != "dtu-train" else readings.train_reading(c, seed, card, what)[0])
        print(f"reading {cell} {what} {seed} {nums}", flush=True)
        assert _fails(nums, c.limits), (seed, nums)
        torch.cuda.empty_cache()
