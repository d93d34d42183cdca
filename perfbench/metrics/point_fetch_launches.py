"""Launches of PointFlow's fused fetch kernel (``point_fetch*``) per map in
the traced window: 3 where each of the three flows makes one unbanded
call. None where no such kernel ran (a program without it)."""
from typing import Optional


def read(run) -> Optional[float]:
    rec = run.record
    if rec is None or rec.items == 0:
        return None
    n = sum(1 for cat, name, _, _ in rec.ops if cat == "kernel" and "point_fetch" in name)
    return n / rec.items if n else None
