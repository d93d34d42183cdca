"""Launches of the plane sweep's kernel (``plane_sweep*``) per map in the
traced window: 1 in a Point-MVSNet forward (its coarse sweep), 3 in a
CasMVSNet forward (a sweep a stage). None where no such kernel ran (a
program without it)."""
from typing import Optional


def read(run) -> Optional[float]:
    rec = run.record
    if rec is None or rec.items == 0:
        return None
    n = sum(1 for cat, name, _, _ in rec.ops if cat == "kernel" and "plane_sweep" in name)
    return n / rec.items if n else None
