"""PointFlow's three EdgeConvs on the device (``point_flow.edge_conv``),
every flow and band, per map, in the span probe (``perfbench/spans.py``),
ms."""
from perfbench import spans

collect = spans.probe


def read(run):
    return spans.device_ms_per_item(run, "point_flow.edge_conv")
