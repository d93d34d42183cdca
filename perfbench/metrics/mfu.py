"""The whole forward's (or, for the ``train`` driver, the whole train
step's) share of the card's peak: operations per item at their dtype's
peak, over the traced window less its ``wait`` spans, %."""
from perfbench import readers

read = readers.mfu
