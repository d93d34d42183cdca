"""The windowed kNN kernels' share of their roofline, %."""
from perfbench import readers

read = readers.knn_roofline
