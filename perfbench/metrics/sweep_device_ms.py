"""Point-MVSNet's coarse plane sweep on the device (``model.sweep``: the
unprojection, the source views' projection and ``plane_sweep_cuda``, or
the composition where no kernel applies), per map, in the span probe
(``perfbench/spans.py``), ms. None where the program has no such span."""
from perfbench import spans

collect = spans.probe


def read(run):
    return spans.device_ms_per_item(run, "model.sweep")
