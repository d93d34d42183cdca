"""The program's own spans on the profiler's clock, for the per-layer
readers that read them.

The program names its phases with ``record_function`` ranges called
``pmvs.<name>`` (``pointmvsnet_tpu_torch/utils/profiler.py::span``):
``predictor.*``, ``model.coarse``, ``model.flow<n>``, ``point_flow.*``
and ``train_step.*``. They exist only while a profiler records. The
traced window's record (``perfbench/trace.py``) keeps the harness's spans
alone, so these readers take a probe of their own in a traced run, after
the window and while the program is alive: the cell's ``trace_items``
items (requests through ``Predictor``, maps, or train steps) once more,
back to back, under ``torch.profiler``, each in the harness span the
window gives it. On a machine without a card there is no probe.

``read_spans`` puts each device operation under the program spans that
were open when the host launched it: its launch is the ``cuda_runtime``
or ``cuda_driver`` event with the same ``args.correlation``, on any
thread (autograd's thread launches the backward's kernels while the train
step's ``backward`` span is open on the main thread). A span's device
time is the union of the intervals of the operations launched under it,
its child spans included. Idle gaps are named by the innermost span open
at their middle, the program's (its ``pmvs.`` dropped) or the harness's.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from perfbench.trace import DEVICE_CATS, WINDOW, _union

PROGRAM = "pmvs."
HARNESS = "perfbench."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
ITEM_SPAN = {"serve": "request", "forward": "map", "train": "step"}


@dataclass
class SpanRecord:
    items: int
    ops: List[Tuple[str, float, float, Tuple[str, ...]]]  # (name, start µs, end µs, spans
    #                                                       open at launch, outermost first)
    gaps: List[Tuple[str, float]]                    # (innermost open span, seconds)
    busy_s: float
    host: Dict[str, List[float]] = field(default_factory=dict)  # seconds of each program span
    unlaunched: int = 0                              # device operations with no launch event

    def device_seconds(self, *spans: str) -> float:
        """Device seconds of the operations launched while any of ``spans``
        was open (their children included), as the union of intervals."""
        want = set(spans)
        return _length([(a, b) for _, a, b, chain in self.ops if want.intersection(chain)])

    def attributed_share(self) -> float:
        """Share of the device's busy time launched under some program span."""
        if self.busy_s <= 0:
            return 0.0
        return _length([(a, b) for _, a, b, chain in self.ops if chain]) / self.busy_s

    def by_innermost(self) -> List[List]:
        """[innermost span at launch ("-" for none), device seconds], most first."""
        by = defaultdict(list)
        for _, a, b, chain in self.ops:
            by[chain[-1] if chain else "-"].append((a, b))
        return sorted(([k, _length(v)] for k, v in by.items()), key=lambda kv: -kv[1])

    def top_ops(self, n: int = 10) -> List[List]:
        """[innermost span at launch, operation's name, device seconds], the
        ``n`` largest pairs."""
        by = defaultdict(float)
        for name, a, b, chain in self.ops:
            by[(chain[-1] if chain else "-", name[:120])] += (b - a) / 1e6
        return [[*k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_span(self) -> List[List]:
        """[span, idle seconds of the gaps it names], most first."""
        by = defaultdict(float)
        for name, sec in self.gaps:
            by[name] += sec
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])

    def top_gaps(self, n: int = 10) -> List[List]:
        return [[k, v] for k, v in sorted(self.gaps, key=lambda kv: -kv[1])[:n]]


def _length(intervals: List[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in _union(intervals)) / 1e6


def _open_at(spans: Sequence[Tuple[float, float, str]],
             times: Sequence[float]) -> List[Tuple[str, ...]]:
    """For each time, the names of the spans that hold it, outermost first
    (the longest first; nesting by time, whatever the thread)."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    by_start = sorted(spans)
    out: List[Tuple[str, ...]] = [()] * len(times)
    active: List[Tuple[float, float, str]] = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(by_start) and by_start[j][0] <= t:
            active.append(by_start[j])
            j += 1
        active = [s for s in active if s[1] >= t]
        out[i] = tuple(s[2] for s in sorted(active, key=lambda s: s[0] - s[1]))
    return out


def read_spans(path: str, items: int) -> SpanRecord:
    """A Chrome trace with one ``perfbench.window`` span → its SpanRecord."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    win = next(e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW)
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])

    def spans(prefix):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(prefix):])
                for e in events if e.get("cat") == "user_annotation"
                and e["name"].startswith(prefix) and e["name"] != WINDOW]

    program, harness = spans(PROGRAM), spans(HARNESS)
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ops, at = [], []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                ops.append((e["name"], a, b))
                at.append(launch.get(e.get("args", {}).get("correlation")))
    known = [i for i, t in enumerate(at) if t is not None]
    chains = dict(zip(known, _open_at(program, [at[i] for i in known])))
    busy = _union([(a, b) for _, a, b in ops])
    idle, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    names = _open_at(program + harness, [(a + b) / 2 for a, b in idle])
    gaps = [(n[-1] if n else "window", (b - a) / 1e6) for n, (a, b) in zip(names, idle)]
    host = defaultdict(list)
    for a, b, name in program:
        if w0 <= a and b <= w1:
            host[name].append((b - a) / 1e6)
    return SpanRecord(items=items,
                      ops=[(n, a, b, chains.get(i, ())) for i, (n, a, b) in enumerate(ops)],
                      gaps=gaps, busy_s=sum(b - a for a, b in busy) / 1e6, host=dict(host),
                      unlaunched=len(at) - len(known))


def profile_items(item: Callable[[int], None], count: int, span: str,
                  device: torch.device) -> SpanRecord:
    """``item(0..count-1)`` under ``torch.profiler`` (the card's activity too
    on a card), each in ``perfbench.<span>``, in one ``perfbench.window``
    closed by a synchronize → the SpanRecord. The trace goes to a directory
    of its own under ``TMPDIR`` and is deleted once read."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            for i in range(count):
                with torch.profiler.record_function(HARNESS + span):
                    item(i)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    run_dir = tempfile.mkdtemp(prefix="perfbench-spans-")
    try:
        path = os.path.join(run_dir, "trace.json")
        prof.export_chrome_trace(path)
        return read_spans(path, count)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def driver_item(driver, kind: str) -> Callable[[int], None]:
    """One item of the cell's traffic, as its driver's window plays it."""
    if kind == "serve":
        def request(i):
            frames, cams, _ = driver.scenes[i % len(driver.scenes)]
            driver.pred(frames, cams)
        return request
    if kind == "forward":
        return driver._map
    if kind == "train":
        return lambda i: driver.step(driver.state, driver.batches[i % len(driver.batches)])
    raise ValueError(f"no probe for the {kind!r} driver")


def probe(run) -> Optional[SpanRecord]:
    """The probe, once per run (``run.memo["spans"]``); None without a card.
    Its breakdown by span goes to standard error."""
    def measure():
        d = run.driver
        if d.device.type != "cuda":
            return None
        kind = run.cell.traffic["driver"]
        rec = profile_items(driver_item(d, kind), run.cell.traffic["trace_items"],
                            ITEM_SPAN[kind], d.device)
        print(f"perfbench: spans over {rec.items} items: busy {rec.busy_s:.6f} s, "
              f"{100 * rec.attributed_share():.3f}% under a program span, "
              f"{rec.unlaunched} operations with no launch event", file=sys.stderr)
        print(f"perfbench: spans, device s by innermost span: {json.dumps(rec.by_innermost())}",
              file=sys.stderr)
        print(f"perfbench: spans, top operations: {json.dumps(rec.top_ops(12))}",
              file=sys.stderr)
        print(f"perfbench: spans, idle s by span: {json.dumps(rec.idle_by_span())}",
              file=sys.stderr)
        print(f"perfbench: spans, idle gaps: {json.dumps(rec.top_gaps(12))}", file=sys.stderr)
        return rec

    return run.once("spans", measure)


def device_ms_per_item(run, *spans: str) -> Optional[float]:
    """Device ms per item of the operations launched under any of ``spans``;
    None where no such operation ran (no card, or a program without the
    spans)."""
    rec = run.memo.get("spans")
    if rec is None or rec.items == 0:
        return None
    s = rec.device_seconds(*spans)
    return None if s <= 0 else 1e3 * s / rec.items


def host_ms(run, span: str) -> Optional[float]:
    """Mean host ms of the program span ``span`` in the probe."""
    rec = run.memo.get("spans")
    if rec is None or not rec.host.get(span):
        return None
    return 1e3 * sum(rec.host[span]) / len(rec.host[span])
