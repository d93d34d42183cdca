"""Smoothed meters for losses, metrics and timings: the port's copy of
``pointmvsnet_tpu/utils/metric_logger.py``, and ``global_summary``, the
meters' averages over every rank's updates."""

from __future__ import annotations

from collections import deque
from typing import Dict

from pointmvsnet_tpu_torch.parallel import distributed


class AverageMeter:
    """Tracks global average and a windowed moving average."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.count = 0
        self.total = 0.0

    def update(self, value: float, n: int = 1) -> None:
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", window_size: int = 20):
        self.meters: Dict[str, AverageMeter] = {}
        self.delimiter = delimiter
        self.window_size = window_size

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            if k not in self.meters:
                self.meters[k] = AverageMeter(self.window_size)
            self.meters[k].update(float(v))

    def __getattr__(self, name: str) -> AverageMeter:
        meters = object.__getattribute__(self, "__dict__").get("meters", {})
        if name in meters:
            return meters[name]
        raise AttributeError(name)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {m.avg:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items())

    @property
    def summary(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}


def global_summary(meters: MetricLogger) -> Dict[str, float]:
    """``meters.summary`` over the updates of every rank: the weighted sums
    and counts of each meter, gathered and added (a rank may have updated
    none)."""
    totals: Dict[str, list] = {}
    for part in distributed.all_gather_object(
            {k: (m.total, m.count) for k, m in meters.meters.items()}):
        for k, (total, count) in part.items():
            t = totals.setdefault(k, [0.0, 0])
            t[0] += total
            t[1] += count
    return {k: total / max(count, 1) for k, (total, count) in totals.items()}
