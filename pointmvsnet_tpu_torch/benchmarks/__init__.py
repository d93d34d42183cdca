"""Benchmarks and probes of the port, one per counterpart in ``benchmarks/``."""
