"""CasMVSNet's third stage (full resolution, 8 hypotheses a pixel) on the
device: the operations launched under ``cascade.stage3``, per map, in the
span probe (``perfbench/spans.py``; the cascade driver's ``probe``), ms."""
from perfbench import spans
from perfbench.drivers import cascade

collect = cascade.probe


def read(run):
    return spans.device_ms_per_item(run, "cascade.stage3")
