"""Faults planted in the measured program, for the checks that show
``correct`` comes out false when the timed path is broken: each is a
context manager that patches the program where the window calls it.

Eval: ``answer_moved`` (the final depth moved one depth interval where it
is produced), ``flow_unchanged`` (a PointFlow iteration returns its input
depth), ``knn_shifted`` (the kNN's selection mask of each point taken from
its left neighbour on the grid), ``masked_max_zeroed`` (the masked window
max returns zeros). Training: ``state_unchanged`` (the optimizer's step
leaves the state as it was), ``half_batch`` (the step sees half of each
batch, its loss the mean over that half).
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch


@contextlib.contextmanager
def answer_moved():
    from pointmvsnet_tpu_torch.models.pointmvsnet import PointMVSNet
    forward = PointMVSNet.forward

    def moved(self, images, cams, **kw):
        out = forward(self, images, cams, **kw)
        if "flow3" in out:
            out["flow3"] = out["flow3"] + cams[:, 0, 1, 3, 1, None, None]   # one interval
        return out
    with mock.patch.object(PointMVSNet, "forward", moved):
        yield


@contextlib.contextmanager
def flow_unchanged():
    from pointmvsnet_tpu_torch.models.pointmvsnet import PointFlow

    def unchanged(self, levels, cams_levels, ref_cam, cur_depth, step, *args, **kw):
        return cur_depth
    with mock.patch.object(PointFlow, "forward", unchanged):
        yield


@contextlib.contextmanager
def knn_shifted():
    from pointmvsnet_tpu_torch.models import pointmvsnet
    knn = pointmvsnet.window_knn_mask

    def shifted(*args, **kw):
        idx, mask = knn(*args, **kw)
        return idx, torch.roll(mask, 1, dims=-1)
    with mock.patch.object(pointmvsnet, "window_knn_mask", shifted):
        yield


@contextlib.contextmanager
def masked_max_zeroed():
    from pointmvsnet_tpu_torch.models import edge_conv

    def zeroed(z, mask, grid_shape, window=5):
        return torch.zeros_like(z)
    with mock.patch.object(edge_conv, "masked_window_max", zeroed):
        yield


@contextlib.contextmanager
def state_unchanged():
    from pointmvsnet_tpu_torch.utils import solver

    def no_update(self, grads):
        self.count += 1
        return True
    with mock.patch.object(solver.Optimizer, "step", no_update):
        yield


@contextlib.contextmanager
def half_batch():
    from pointmvsnet_tpu_torch.parallel import train_step
    make = train_step.make_train_step

    def halved(loss_fn, model_kwargs):
        step = make(loss_fn, model_kwargs)

        def run(state, batch):
            half = batch["images"].shape[0] // 2
            return step(state, {k: v[:half] for k, v in batch.items()})
        return run
    with mock.patch.object(train_step, "make_train_step", halved):
        yield


EVAL = {f.__name__: f for f in (answer_moved, flow_unchanged, knn_shifted, masked_max_zeroed)}
TRAIN = {f.__name__: f for f in (state_unchanged, half_batch)}
