"""CasMVSNet's three plane sweeps' share of their roofline, %: the least
time of their work per map at the cell's stage grids over the device time
of the operations launched under ``cascade.sweep`` per map in the span
probe (``perfbench/spans.py``; the cascade driver's ``probe``).

The work of one stage (D hypotheses over an h × w grid, V views of C
channels at that grid): each input byte read once, the V views' features
in the eval dtype, the hypotheses in f32 (D a map for stage 1's planes,
D·h·w per pixel after), and the cost volume written once in the U-Net's
dtype (the eval dtype), D·h·w·C; 10·(V − 1) + 5 f32 operations per
(hypothesis point, channel) (a bilinear blend per source view, the two
moments, the reference's share and the variance), as the fused
PointFlow fetch counts them (``point_fetch_roofline.py``)."""
from typing import Optional

import torch

from perfbench import spans
from perfbench.counts import bounds
from perfbench.drivers import cascade

collect = cascade.probe


def sweep_bound(views: int, d: int, h: int, w: int, c: int, elem_bytes: int,
                per_pixel: bool):
    """(bytes, operations) of one stage's sweep at B = 1."""
    points = d * h * w
    hyp = points if per_pixel else d
    nbytes = views * h * w * c * elem_bytes + hyp * 4 + points * c * elem_bytes
    return nbytes, points * c * (10 * (views - 1) + 5)


def least_ms(config) -> float:
    """The three sweeps' least time per map, ms."""
    b, m = config["eval"], config["model"]
    esize = torch.finfo(getattr(torch, b["dtype"])).bits // 8
    c = m["IMG_BASE_CHANNELS"]
    total = 0.0
    for s, (d, scale, ch) in enumerate(zip(m["CASCADE"]["NDEPTHS"], (4, 2, 1),
                                           (4 * c, 2 * c, c))):
        total += bounds.bound_ms(*sweep_bound(b["views"], d, b["height"] // scale,
                                              b["width"] // scale, ch, esize, s > 0))[0]
    return total


def read(run) -> Optional[float]:
    measured = spans.device_ms_per_item(run, "cascade.sweep")
    if measured is None:
        return None
    return 100.0 * least_ms(run.cell.config) / measured
