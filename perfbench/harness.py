"""One run of one benchmark cell, driven by data.

``BENCHMARK.json`` names the cell's configuration, traffic and metrics;
the harness finds each by its name: ``configs/<config>.json`` (sizes),
``traffic/<traffic>.json`` (the mix, with the driver that plays it,
``drivers/<driver>.py``), ``limits/<cell>.json`` (the limit of each
number the correctness check compares) and ``metrics/<metric>.py`` (a
per-layer reader; ``load_metric`` says how a split name finds it). A run:
set-up (weights and inputs from the seed, the program built and warmed up
on the cell's shapes), the measured window, then, where traced, the
per-layer readers' probes; the program's state is freed and the plain
reference decides ``correct``. The last line of standard output is the
result.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from perfbench.trace import Tracer

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pointmvsnet_tpu")
GIB = 2.0 ** 30


@dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    chips: int = 1
    end_to_end: Dict[str, Dict] = field(default_factory=dict)   # name → BENCHMARK entry
    per_layer: Dict[str, Dict] = field(default_factory=dict)


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json",
              base: Path = HERE) -> Cell:
    bench = _json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    limits_path = base / "limits" / f"{name}.json"
    return Cell(
        name=name,
        config=_json(base / "configs" / f"{w['config']}.json"),
        traffic=_json(base / "traffic" / f"{w['traffic']}.json"),
        limits=_json(limits_path) if limits_path.exists() else {},
        chips=w["chips"],
        end_to_end={m["name"]: m for m in bench["end_to_end"] if _reports(m, name)},
        per_layer={m["name"]: m for m in bench["per_layer"] if _reports(m, name)})


def load_metric(name: str, base: Path = HERE):
    """``metrics/<name>.py`` as a module (names hold dots, so by path); where
    there is none, ``metrics/<name less its last .part>.py``: one reader
    serves a quantity split by what it moves (``mfu.serve``, ``mfu.train``
    → ``mfu.py``)."""
    path = base / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = base / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


@dataclass
class Run:
    """What a per-layer reader sees: the cell, the live driver (until the
    program is freed), the traced record and a memo the readers share."""
    cell: Cell
    driver: Any
    record: Any
    memo: Dict[str, Any] = field(default_factory=dict)

    def once(self, key: str, fn):
        if key not in self.memo:
            self.memo[key] = fn()
        return self.memo[key]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t0: float, log=sys.stderr) -> Dict[str, Any]:
    """Set-up, window, probes, reference → the result's fields (without
    ``device``)."""
    driver = load_driver(cell.traffic["driver"]).Driver(cell, seed, device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    tracer = Tracer(trace, cell.traffic.get("trace_skip", 0), cell.traffic.get("trace_items", 0))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window = driver.window(seconds, tracer)
    tracer.close()
    window_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"perfbench: setup {setup_s:.3f} s, window {window['values']}", file=log, flush=True)

    readers = {n: load_metric(n) for n in cell.per_layer} if trace else {}
    run = Run(cell, driver, tracer.record)
    for mod in readers.values():
        if hasattr(mod, "collect"):
            mod.collect(run)
    driver.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    try:
        numbers = driver.check(run.memo)
    except Exception:                        # the reference failed: nothing compared
        traceback.print_exc(file=log)
        numbers = {"reference_ran": math.inf}
    checks = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in numbers.items()}
    correct = (window["failed"] == 0 and bool(checks)
               and all(c["limit"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))

    out: Dict[str, Any] = {"correct": correct, "attempted": window["attempted"],
                           "failed": window["failed"]}
    if trace:
        metrics = {}
        for name, mod in readers.items():
            value = mod.read(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": cell.per_layer[name]["unit"]}
        out["metrics"] = metrics
    else:
        values = dict(window["values"], setup_s=setup_s,
                      peak_mem_gib=window_peak / GIB)
        out["metrics"] = {n: {"value": values[n], "unit": m["unit"]}
                          for n, m in cell.end_to_end.items()}
    out["memory_peak_bytes"] = max(setup_peak, window_peak)
    if trace and tracer.record is not None:
        rec = tracer.record
        out["busy_s"], out["window_s"] = rec.busy_s, rec.window_s
        out["breakdown"] = {"device_ops": rec.top_ops(), "idle_gaps": rec.top_gaps()}
    out["checks"] = checks
    return out


def power_limit(device: torch.device) -> str:
    """The card's power limit from ``nvidia-smi``, asked for by UUID."""
    import subprocess
    uuid = str(torch.cuda.get_device_properties(device).uuid)
    uuid = uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"
    try:
        res = subprocess.run(["nvidia-smi", f"--id={uuid}", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return res.stdout.strip() if res.returncode == 0 else f"unknown ({res.stderr.strip()})"


def main(argv: Optional[List[str]] = None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t0)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 3
    limit = power_limit(device)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
           "memory_peak_bytes": out.pop("memory_peak_bytes"), "power_limit": limit}
    if args.trace:
        dev["busy_s"], dev["window_s"] = out.pop("busy_s", 0.0), out.pop("window_s", 0.0)
    checks = out.pop("checks")
    line = dict(out, device=dev)
    if "breakdown" in line:
        line["breakdown"] = line.pop("breakdown")
    line["checks"] = checks
    for name, m in line["metrics"].items():
        print(f"perfbench: {name} = {m['value']} {m['unit']} (card power limit {limit})",
              file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
