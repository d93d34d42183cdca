"""PointFlow iteration 3: the full eval forward less the two-flow forward
(nested prefixes, median of 5 synchronized calls), ms."""
from perfbench import readers

collect = readers.collect_stages


def read(run):
    return readers.stage_ms(run, "flow3")
