"""Readings that set a cell's limits, on the card (the benchmark's own
runs do not run this):

    python3 perfbench/tools/readings.py --workload <cell> --seeds 1,2,3 \
        --what program|control|half_batch|self|<fault> [--seconds 4]

``program``: whole runs of the cell (set-up, a short window, the
reference) on each seed, in one process; prints each run's numbers.
``control``: the reference put in the program's place, computed one
precision below the configuration's (fp8 for a bf16 config, TF32 for an
f32 one), against the f32 reference on the same inputs.
``half_batch`` (training): the reference on half of each batch, its loss
the mean over the rest. ``self`` (training): the f32 reference against
itself, run twice on the card. ``answer_moved``, ``flow_unchanged``,
``knn_shifted``, ``masked_max_zeroed`` (eval): ``program`` with that fault
of ``perfbench/tools/faults.py`` planted. One JSON line per seed; a training line
also holds each step's losses and the worst leaves of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import harness, inputs  # noqa: E402
from perfbench.check import compare_steps, leaf_detail  # noqa: E402
from perfbench.drivers import common  # noqa: E402
from perfbench.drivers.train import make_batches, reference_steps  # noqa: E402
from perfbench.tools import faults  # noqa: E402
from perfbench.reference.model import request_inputs  # noqa: E402
from perfbench.trace import Tracer  # noqa: E402

BELOW = {"bfloat16": "fp8", "float32": "tf32"}


def eval_control(cell, seed: int, device) -> dict:
    b, tr = cell.config["eval"], cell.traffic
    scenes = inputs.scene_pool(seed, tr["pool"], b["views"], b["height"], b["width"],
                               b["num_depth"], tr.get("plane_fracs", (0.25, 0.70)))
    weights = common.seeded_weights(cell.config, seed, device, calibrate=True)
    ref = common.EvalReference(cell.config, weights, device)
    low = common.reference(cell.config, weights, device, BELOW[b["dtype"]])
    tensors = [tuple(t.to(device) for t in request_inputs(f, c)) for f, c, _ in scenes]
    answers = [(j, common.reference_maps(low, *tensors[j], ref.kwargs))
               for j in range(len(scenes))]
    return common.eval_numbers(ref, lambda j: tensors[j], answers, inputs.rng(seed, "check"))


def train_reading(cell, seed: int, device, what: str):
    b = cell.config["train"]
    batches = make_batches(seed, b, cell.traffic, device)
    weights = common.seeded_weights(cell.config, seed, device)
    kwargs = common.forward_kwargs(b)
    ref, raw = reference_steps(cell.config, weights, batches, kwargs, device)
    kw = {"control": dict(precision=BELOW[b["dtype"]]), "self": {},
          "half_batch": dict(batch_slice=slice(0, b["batch"] // 2))}[what]
    cand, _ = reference_steps(cell.config, weights, batches, kwargs, device, **kw)
    return compare_steps(cand, ref, raw), {"detail": leaf_detail(cand, ref)}


def program_reading(cell, seed: int, seconds: float, device):
    """A run of the cell without its result line: set-up, window, the
    program freed, the reference's comparison."""
    driver = harness.load_driver(cell.traffic["driver"]).Driver(cell, seed, device)
    window = driver.window(seconds, Tracer(False))
    driver.free()
    torch.cuda.empty_cache()
    memo = {}
    nums = driver.check(memo)
    extra = {"window": window["values"], "attempted": window["attempted"],
             "failed": window["failed"]}
    if "reference_steps" in memo:
        extra["detail"] = leaf_detail(driver.summary, memo["reference_steps"])
    return nums, extra


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", required=True,
                   choices=("program", "control", "half_batch", "self", *faults.EVAL))
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.what == "program":
            nums, extra = program_reading(cell, seed, args.seconds, device)
        elif args.what in faults.EVAL:
            with faults.EVAL[args.what]():
                nums, extra = program_reading(cell, seed, args.seconds, device)
        elif cell.traffic["driver"] == "train":
            nums, extra = train_reading(cell, seed, device, args.what)
        else:
            nums, extra = eval_control(cell, seed, device), {}
        print(json.dumps({"workload": args.workload, "what": args.what, "seed": seed,
                          "numbers": nums, "s": time.perf_counter() - t0, **extra}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
