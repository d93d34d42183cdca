"""The masked window max kernels' share of their roofline, %."""
from perfbench import readers

read = readers.mwm_roofline
