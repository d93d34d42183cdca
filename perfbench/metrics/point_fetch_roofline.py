"""PointFlow's fused fetch kernel's share of its roofline, %: the least
time of the fetch's work per map at the cell's flow grids over the CUPTI
time of the kernels named ``point_fetch*`` per traced map. None where no
such kernel ran.

The work of one flow grid (G hypotheses of n pixels, N = G·n points, V
views, level l of the source views at (h, w) / 2^l with C_l channels):
each input byte read once, the source views' uv (8 B) and z (4 B) a
point, the hypothesis depths (4 B a point), the V − 1 source views of
every level in the eval dtype and the reference view's f32 samples
(n × ΣC_l), and the output written once, N × ΣC_l in the first EdgeConv's
dtype (the eval dtype); 10·(V − 1) + 5 f32 operations per (point,
channel) (the bilinear blend, the two moments, the reference's share and
the variance). ``perfbench/tests/test_perfbench_point_fetch.py`` holds
``fetch_bound`` to the on-card smoke test's ``point_fetch_bound``, which
counts the same bytes from the kernel's arguments."""
from typing import Optional

import torch

from perfbench.counts import bounds
from perfbench.readers import _flow_grids


def fetch_bound(views: int, g: int, h: int, w: int, widths, elem_bytes: int):
    """(bytes, operations) of the fused fetch at one (g, h, w) flow grid."""
    n, s, ctot = h * w, views - 1, sum(widths)
    levels = sum((h >> l) * (w >> l) * c for l, c in enumerate(widths))
    nbytes = (g * n * s * 12 + g * n * 4 + s * levels * elem_bytes + n * ctot * 4
              + g * n * ctot * elem_bytes)
    return nbytes, g * n * ctot * (10 * s + 5)


def read(run) -> Optional[float]:
    rec = run.record
    if rec is None or rec.items == 0:
        return None
    measured = rec.kernel_seconds("point_fetch") / rec.items
    if measured <= 0:
        return None
    b = run.cell.config["eval"]
    c = run.cell.config["model"]["IMG_BASE_CHANNELS"]
    esize = torch.finfo(getattr(torch, b["dtype"])).bits // 8
    least = sum(bounds.bound_ms(*fetch_bound(b["views"], g, h, w, (c, 2 * c, 4 * c), esize))[0]
                for g, h, w in _flow_grids(run)) / 1e3
    return 100.0 * least / measured
