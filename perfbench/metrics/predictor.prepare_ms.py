"""Predictor's host preparation of a request (``predictor.prepare``: the
float32 conversion, the crop, ``norm_image`` per view, the stack), mean
span duration over the span probe's requests (``perfbench/spans.py``), ms."""
from perfbench import spans

collect = spans.probe


def read(run):
    return spans.host_ms(run, "predictor.prepare")
