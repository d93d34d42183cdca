"""PointFlow iteration 3 on the device: the device time of the operations
launched under the program's ``model.flow3`` span, per map, in the span
probe (``perfbench/spans.py``), ms."""
from perfbench import spans

collect = spans.probe


def read(run):
    return spans.device_ms_per_item(run, "model.flow3")
