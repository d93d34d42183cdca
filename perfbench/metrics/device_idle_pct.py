"""Share of the traced window with no operation on the device, the window
less its ``wait`` spans (an open loop's wait for its next arrival), %."""
from perfbench import readers

read = readers.idle_pct
