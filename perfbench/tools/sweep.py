"""The serve cell's load sweep, on the card (the benchmark's own runs do
not run this): one set-up, then the closed loop (each request sent when
the last returns: the sustained rate) and the open loop at each of
``--rates``:

    python3 perfbench/tools/sweep.py --workload dtu-serve --seed 7 --seconds 20 \
        --rates 2.0,2.5,3.0

One JSON line per load: maps/s, and request p50 / p90 (ms, from when each
was due).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import harness  # noqa: E402
from perfbench.trace import Tracer  # noqa: E402



def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="dtu-serve")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    driver = harness.load_driver(cell.traffic["driver"]).Driver(cell, args.seed,
                                                                  torch.device("cuda", 0))
    frames, cams, _ = driver.scenes[0]
    t0, n = time.perf_counter(), 0
    while time.perf_counter() - t0 < args.seconds:
        driver.pred(frames, cams)
        n += 1
    print(json.dumps({"closed_loop_maps_per_s": n / (time.perf_counter() - t0)}), flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        driver.answers.clear()
        cell.traffic["rate_per_s"] = rate
        t0 = time.perf_counter()
        out = driver.window(args.seconds, Tracer(False))
        print(json.dumps({"rate_per_s": rate, "s": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
