"""Train and eval steps: counterpart of
``pointmvsnet_tpu/parallel/train_step.py``.

The JAX package's state is immutable and its step returns a new one; here
``TrainState`` holds the model (parameters and BatchNorm statistics, updated
in place), the optimizer (its state in place too) and the step counter,
and a step returns the same object. As in the JAX package, BatchNorm
statistics blend on every train step, also one whose update the optimizer
skips for non-finite gradients, and the counter counts both.

Under data parallelism (``parallel/distributed.py``) each rank runs the
step on its rows of the global batch: the loss divides by the global
count, BatchNorm reduces over the global batch, and the gradients are
sum-all-reduced as one flat buffer before the optimizer, so every rank
applies the same update and makes the same skip decision. Not DDP's
wrapper: it averages gradients, and it overlaps its bucket reductions with
a backward that issues sync-BN's collectives inside EdgeConv's
checkpointed recompute. The losses and metrics a step returns are the
global values on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from pointmvsnet_tpu_torch.parallel import distributed
from pointmvsnet_tpu_torch.utils.solver import Optimizer

BATCH_KEYS = ("images", "cams", "gt_depth")


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0


def put_batch(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """The loader's numpy batch → the model's inputs on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
            for k in BATCH_KEYS if k in batch}


def _global(values: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """Detached per-rank parts → their sums over the ranks of ``group``
    (default: all), one all-reduce."""
    if not values:
        return {}
    keys = sorted(values)
    flat = distributed.all_reduce_sum_(torch.stack([values[k].detach().float() for k in keys]),
                                       group)
    return dict(zip(keys, flat.unbind()))


def all_reduce_grads(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """name → gradient summed over the ranks (zeros for a parameter without
    one), all-reduced as one flat buffer."""
    params = list(model.named_parameters())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for _, p in params]
    if not distributed.active():
        return {n: g for (n, _), g in zip(params, grads)}
    flat = distributed.all_reduce_sum_(torch.cat([g.reshape(-1) for g in grads]))
    out = {}
    for (n, p), part in zip(params, flat.split([g.numel() for g in grads])):
        p.grad = part.view_as(p)
        out[n] = p.grad
    return out


def make_train_step(loss_fn: Callable, model_kwargs: Dict[str, Any]) -> Callable:
    """→ ``step(state, batch) -> (state, losses)``: forward in training
    mode, loss, backward, gradient all-reduce, optimizer. ``model_kwargs``
    are the forward's options (is_flow, img_scales, inter_scales,
    num_virtual_plane); the curriculum makes one step function per phase.
    ``loss_fn`` takes ``sharded=``. The (global) gradients stay in each
    parameter's ``.grad`` after the step. ``losses`` are detached tensors
    on the card (no host sync) plus the optimizer's ``skipped_steps`` and
    ``consecutive_skipped``."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        model.train()
        model.zero_grad(set_to_none=True)
        preds = model(batch["images"], batch["cams"], **model_kwargs)
        losses = loss_fn(preds, batch["gt_depth"], batch["cams"], sharded=True)
        losses["total_loss"].backward()
        state.optimizer.step(all_reduce_grads(model))
        state.step += 1
        out = _global(losses)
        out["skipped_steps"] = state.optimizer.skipped_steps
        out["consecutive_skipped"] = state.optimizer.consecutive_skipped
        return state, out

    return step


def make_eval_step(loss_fn: Optional[Callable], metric_fn: Optional[Callable],
                   model_kwargs: Dict[str, Any], sharded: bool = True,
                   grid: Optional[distributed.EvalGrid] = None) -> Callable:
    """→ ``eval_step(state, batch) -> (preds, losses, metrics)``: the eval
    forward (running BatchNorm statistics, the masked-max fast path) with
    no gradient; losses and metrics are empty without ``gt_depth``.
    ``sharded``: the batch is this rank's rows of a global batch that every
    rank evaluates together (validation), and the losses and metrics come
    back as the global batch's; else they are this batch's own (the test
    CLI, where each rank exports its own items). On an eval ``grid`` the
    global batch is sharded over the data axis only: the ranks of one band
    and view group hold the same rows, and the sums run over the data
    group."""
    group = grid.data_group if grid is not None else None

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        model.eval()
        with torch.inference_mode():
            preds = model(batch["images"], batch["cams"], **model_kwargs)
            has_gt = "gt_depth" in batch
            kw = dict(sharded=sharded, group=group)
            losses = (loss_fn(preds, batch["gt_depth"], batch["cams"], **kw)
                      if loss_fn is not None and has_gt else {})
            metrics = (metric_fn(preds, batch["gt_depth"], batch["cams"], **kw)
                       if metric_fn is not None and has_gt else {})
            if sharded:
                losses, metrics = _global(losses, group), _global(metrics, group)
        return preds, losses, metrics

    return step
