"""The train step's forward and loss on the device (``train_step.forward``
and ``train_step.loss``), per step, in the span probe
(``perfbench/spans.py``), ms."""
from perfbench import spans

collect = spans.probe


def read(run):
    return spans.device_ms_per_item(run, "train_step.forward", "train_step.loss")
