"""The traced run's record: ``torch.profiler`` over a few items of the
window, read back from its Chrome trace.

``Tracer`` profiles items [skip, skip + count) of a window (requests,
maps or steps), with the harness's own spans (``record_function`` named
``perfbench.<span>``) around the calls into the program. ``Record`` holds
what the per-layer readers take from it: the device's operations (kernels,
copies, fills) inside the traced window, its busy time as the union of
their intervals, and the idle gaps, each named by the innermost harness
span open at its middle; and the same less the harness's ``wait`` spans,
in which an open loop waits for its next arrival and the program has
nothing to do. The trace file goes to a directory of the run's
own under ``TMPDIR`` and is deleted once read.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "perfbench.window"


@dataclass
class Record:
    window_s: float
    items: int
    ops: List[Tuple[str, str, float, float]]      # (category, name, start µs, dur µs)
    gaps: List[Tuple[str, float]]                 # (innermost open span, seconds)
    busy_s: float
    active_s: float = 0.0          # the window less its ``wait`` spans (an open loop's idle)
    active_busy_s: float = 0.0     # busy_s less device time inside ``wait`` spans
    host: Dict[str, List[float]] = field(default_factory=dict)   # the window's host timings

    def kernel_seconds(self, name: str) -> float:
        """Device seconds of the kernels whose name holds ``name``."""
        return sum(d for c, n, _, d in self.ops if c == "kernel" and name in n) / 1e6

    def kernels(self) -> int:
        return sum(1 for c, *_ in self.ops if c == "kernel")

    def top_ops(self, n: int = 10) -> List[List]:
        by = defaultdict(float)
        for _, name, _, dur in self.ops:
            by[name] += dur / 1e6
        return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> List[List]:
        return [[k, v] for k, v in sorted(self.gaps, key=lambda kv: -kv[1])[:n]]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def read_trace(path: str, items: int) -> Record:
    """A Chrome trace with one ``perfbench.window`` span → its Record."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    win = next(e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW)
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    ops = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                ops.append((e["cat"], e["name"], a, b - a))
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len("perfbench."):])
             for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("perfbench.") and e["name"] != WINDOW]
    busy = _union([(a, a + d) for _, _, a, d in ops])
    waits = _union([(max(a, w0), min(b, w1)) for a, b, name in spans
                    if name == "wait" and min(b, w1) > max(a, w0)])
    waited = sum(b - a for a, b in waits)
    busy_waiting = sum(max(0.0, min(b, d) - max(a, c)) for a, b in busy for c, d in waits)
    gaps, at = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > at:
            mid = (a + at) / 2
            open_ = [s for s in spans if s[0] <= mid <= s[1]]
            name = min(open_, key=lambda s: s[1] - s[0])[2] if open_ else "window"
            gaps.append((name, (a - at) / 1e6))
        at = max(at, b)
    busy_s = sum(b - a for a, b in busy) / 1e6
    return Record(window_s=(w1 - w0) / 1e6, items=items, ops=ops, gaps=gaps, busy_s=busy_s,
                  active_s=(w1 - w0 - waited) / 1e6,
                  active_busy_s=busy_s - busy_waiting / 1e6)


class Tracer:
    """Profiles items [skip, skip + count) of a window when ``enabled``.
    Drivers wrap each item in ``item(i)`` and each call into the program
    in ``span(name)``; ``active`` says whether the current item is traced."""

    def __init__(self, enabled: bool, skip: int = 0, count: int = 0):
        self.enabled, self.skip, self.count = enabled, skip, count
        self.active = False
        self.host: Dict[str, List[float]] = defaultdict(list)
        self._prof = self._win = None
        self._traced = 0
        self.record: Optional[Record] = None

    @contextlib.contextmanager
    def item(self, i: int):
        if self.enabled and i == self.skip and self.record is None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if torch.cuda.is_available() else [])
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._win = torch.profiler.record_function(WINDOW)
            self._win.__enter__()
            self.active, self._traced = True, 0
        yield
        if self.active:
            self._traced += 1
            if self._traced == self.count:
                self.close()

    def close(self) -> None:
        """Stop profiling (after the last traced item, or where the window
        ended before it) and read the trace; attach the host timings of the
        window's items so far."""
        if self.active:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._win.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            self.active = False
            run_dir = tempfile.mkdtemp(prefix="perfbench-trace-")
            try:
                path = os.path.join(run_dir, "trace.json")
                self._prof.export_chrome_trace(path)
                self.record = read_trace(path, self._traced)
            finally:
                shutil.rmtree(run_dir, ignore_errors=True)
                self._prof = self._win = None
        if self.record is not None:
            self.record.host = dict(self.host)

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"perfbench.{name}")

    def note(self, key: str, value: float) -> None:
        """A host timing, kept for every item of a traced run's window."""
        if self.enabled:
            self.host[key].append(value)

