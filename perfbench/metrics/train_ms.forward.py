"""The train step's forward (the loss forward without gradient; the
forward with backward less it), median of 5 synchronized calls, ms."""
from perfbench import readers

collect = readers.collect_train_stages


def read(run):
    return readers.train_ms(run, "forward")
