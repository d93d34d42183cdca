"""Runs of the harness with the timed path broken underneath, at 64x128 on
the CPU (the chip's look skipped): each fault a cell can have
(``perfbench/tools/faults.py``) makes ``correct`` false, and the sound run
beside them stays true. The limits are the cells' own, from
``perfbench/limits/``. With ``-m chip``, the kernel faults at the eval
cells' own size on the card."""

import pytest
import torch

from perfbench import harness
from perfbench.tools import faults, readings
from tiny import run_tiny

EVAL_CELLS = ("dtu-serve", "tt-forward")
FAULTS = [("dtu-serve", f) for f in faults.EVAL]
FAULTS += [("tt-forward", "answer_moved"), ("tt-forward", "knn_shifted")]
FAULTS += [("dtu-train", f) for f in faults.TRAIN]
SEEDS = (2 ** 31 + 201, 2 ** 31 + 202, 2 ** 31 + 203)


def _fault(name):
    return {**faults.EVAL, **faults.TRAIN}[name]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_makes_the_run_incorrect(cell, fault):
    with _fault(fault)():
        out = run_tiny(cell, seconds=0.3)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values()), out["checks"]


@pytest.mark.parametrize("cell", [*EVAL_CELLS, "dtu-train"])
def test_the_sound_run_is_correct(cell):
    out = run_tiny(cell, seconds=0.3)
    assert out["correct"] is True, out["checks"]


def test_an_answer_that_never_comes_fails(monkeypatch):
    from pointmvsnet_tpu_torch.predictor import Predictor

    def broken(self, images, cams):
        raise RuntimeError("no answer")
    monkeypatch.setattr(Predictor, "__call__", broken)
    with pytest.raises(RuntimeError):
        run_tiny("dtu-serve", seconds=0.3)              # its warm-up already fails
    monkeypatch.undo()
    calls = {"n": 0}
    call = Predictor.__call__

    def flaky(self, images, cams):
        calls["n"] += 1
        if calls["n"] == 2:                          # the window's first request
            raise RuntimeError("no answer")
        return call(self, images, cams)
    monkeypatch.setattr(Predictor, "__call__", flaky)
    out = run_tiny("dtu-serve", seconds=0.3)
    assert out["failed"] == 1 and out["correct"] is False


@pytest.mark.chip
@pytest.mark.parametrize("cell,fault", [("dtu-serve", "knn_shifted"),
                                        ("dtu-serve", "masked_max_zeroed"),
                                        ("tt-forward", "knn_shifted")])
def test_a_kernel_fault_fails_at_the_cells_size(card, cell, fault):
    c = harness.load_cell(cell)
    for seed in SEEDS:
        with _fault(fault)():
            nums, _ = readings.program_reading(c, seed, 2.0, card)
        print(f"reading {cell} {fault} {seed} {nums}", flush=True)
        assert any(not v <= c.limits[k] for k, v in nums.items()), (seed, nums)
        torch.cuda.empty_cache()
