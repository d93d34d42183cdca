"""Cells cut to a size the CPU runs in seconds, for the tests: the
configuration's widths stay, the frames shrink to 64x128 with 16 depth
planes, batches to 2."""

import torch

from perfbench import harness


def tiny_cell(name: str, **traffic):
    cell = harness.load_cell(name)
    for block in ("eval", "train"):
        if block in cell.config:
            cell.config[block].update(height=64, width=128, num_depth=16)
    if "train" in cell.config:
        cell.config["train"]["batch"] = 2
    cell.traffic = dict(cell.traffic, pool=2, rate_per_s=8.0, warmup=1, trace_skip=1,
                        trace_items=2, check_maps=2, **traffic)
    return cell


def run_tiny(name: str, seed: int = 2 ** 31 + 12345, seconds: float = 1.0, trace=False,
             **traffic):
    cell = tiny_cell(name, **traffic)
    import time
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())
