"""The train step's backward on the device (``train_step.backward``, whose
kernels autograd's thread launches while the span is open), per step, in
the span probe (``perfbench/spans.py``), ms."""
from perfbench import spans

collect = spans.probe


def read(run):
    return spans.device_ms_per_item(run, "train_step.backward")
