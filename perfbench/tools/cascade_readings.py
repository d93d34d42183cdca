"""Readings that set ``cas-dtu-forward``'s limits, on the card (the
benchmark's own runs do not run this):

    python3 perfbench/tools/cascade_readings.py --seeds 1,2,3 \
        --what program|control|not_recentred|argmax_confidence [--seconds 4]

``program``: whole runs of the cell (set-up, a short window, the
reference) on each seed, in one process; prints each run's numbers.
``control``: the reference computed in fp8 (e4m3 operands, one precision
below the configuration's bf16) put in the program's place, against the
f32 reference on the same inputs. The faults are ``program`` with the
program broken where the window calls it: ``not_recentred`` (stages 2
and 3 search around the mean of the previous depth map instead of each
pixel's own depth), ``argmax_confidence`` (each stage's confidence taken
at the argmax, not at the regressed index). One JSON line per seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import harness, inputs  # noqa: E402
from perfbench.drivers import cascade  # noqa: E402
from perfbench.tools.readings import program_reading  # noqa: E402

CELL = "cas-dtu-forward"


@contextlib.contextmanager
def not_recentred():
    from pointmvsnet_tpu_torch.models import casmvsnet
    hypotheses = casmvsnet.stage_hypotheses

    def around_the_mean(depth, *args, **kw):
        cur, _ = hypotheses(depth, *args, **kw)
        flat = depth.mean(dim=(1, 2), keepdim=True).expand_as(depth)
        return cur, hypotheses(flat, *args, **kw)[1]
    with mock.patch.object(casmvsnet, "stage_hypotheses", around_the_mean):
        yield


@contextlib.contextmanager
def argmax_confidence():
    from pointmvsnet_tpu_torch.models import casmvsnet
    from pointmvsnet_tpu_torch.ops.cost_volume import photometric_confidence
    with mock.patch.object(casmvsnet, "regressed_confidence", photometric_confidence):
        yield


FAULTS = {f.__name__: f for f in (not_recentred, argmax_confidence)}


def control(cell, seed: int, device) -> dict:
    """The fp8 reference's answers for the cell's scenes, compared as the
    program's are."""
    b, tr = cell.config["eval"], cell.traffic
    tensors = [tuple(t.to(device) for t in s)
               for s in cascade.scenes(seed, b, tr["pool"], tr.get("plane_fracs", (0.25, 0.70)))]
    weights = cascade.seeded_weights(cell.config, seed, device)
    low = cascade.reference(cell.config, weights, device, "fp8")
    answers = [(j, cascade.reference_maps(low, *tensors[j], b["num_depth"]))
               for j in range(len(tensors))]
    del low
    return cascade.numbers(answers, lambda j: tensors[j], cell.config, weights, device,
                           inputs.rng(seed, "check"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", required=True, choices=("program", "control", *FAULTS))
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)
    cell = harness.load_cell(CELL)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        extra = {}
        if args.what == "control":
            nums = control(cell, seed, device)
        else:
            with FAULTS[args.what]() if args.what in FAULTS else contextlib.nullcontext():
                nums, extra = program_reading(cell, seed, args.seconds, device)
        print(json.dumps({"workload": CELL, "what": args.what, "seed": seed, "numbers": nums,
                          "s": time.perf_counter() - t0, **extra}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
