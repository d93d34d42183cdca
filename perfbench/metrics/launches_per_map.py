"""Device kernels launched per map in the traced window."""
from perfbench import readers

read = readers.launches_per_item
