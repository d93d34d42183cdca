"""CasMVSNet's ``cascade.sweep`` on the device, every stage, per map, in the
span probe (``perfbench/spans.py``; the cascade driver's ``probe``), ms."""
from perfbench import spans
from perfbench.drivers import cascade

collect = cascade.probe


def read(run):
    return spans.device_ms_per_item(run, "cascade.sweep")
