"""PointFlow's fetch on the device (``point_flow.fetch``: the hypothesis
points, the reference view's regular samples, ``fetch_features_perlevel``
and the variance), every flow and band, per map, in the span probe
(``perfbench/spans.py``), ms."""
from perfbench import spans

collect = spans.probe


def read(run):
    return spans.device_ms_per_item(run, "point_flow.fetch")
