"""Tensor ops of the eval path: geometry, sampling, cost volume, and the
two kernels (windowed kNN, masked window max) with their plain versions."""
