"""Predictor host work per request (crop, norm_image, copies to and from
the card): the request less its synchronized model call, mean over the
traced requests, ms."""
from perfbench import readers

read = readers.host_ms
