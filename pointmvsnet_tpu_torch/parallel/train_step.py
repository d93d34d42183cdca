"""Train and eval steps on one card: counterpart of
``pointmvsnet_tpu/parallel/train_step.py`` without the mesh.

The JAX package's state is immutable and its step returns a new one; here
``TrainState`` holds the model (parameters and BatchNorm statistics, updated
in place), the optimizer (its state in place too) and the step counter,
and a step returns the same object. As in the JAX package, BatchNorm
statistics blend on every train step, also one whose update the optimizer
skips for non-finite gradients, and the counter counts both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

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


def make_train_step(loss_fn: Callable, model_kwargs: Dict[str, Any]) -> Callable:
    """→ ``step(state, batch) -> (state, losses)``: forward in training
    mode, loss, backward, optimizer. ``model_kwargs`` are the forward's
    options (is_flow, img_scales, inter_scales, num_virtual_plane); the
    curriculum makes one step function per phase. Gradients stay in each
    parameter's ``.grad`` after the step. ``losses`` are detached tensors
    on the card (no host sync) plus the optimizer's ``skipped_steps`` and
    ``consecutive_skipped``."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        model.train()
        model.zero_grad(set_to_none=True)
        preds = model(batch["images"], batch["cams"], **model_kwargs)
        losses = loss_fn(preds, batch["gt_depth"], batch["cams"])
        losses["total_loss"].backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in model.named_parameters()}
        state.optimizer.step(grads)
        state.step += 1
        out = {k: v.detach() for k, v in losses.items()}
        out["skipped_steps"] = state.optimizer.skipped_steps
        out["consecutive_skipped"] = state.optimizer.consecutive_skipped
        return state, out

    return step


def make_eval_step(loss_fn: Optional[Callable], metric_fn: Optional[Callable],
                   model_kwargs: Dict[str, Any]) -> Callable:
    """→ ``eval_step(state, batch) -> (preds, losses, metrics)``: the eval
    forward (running BatchNorm statistics, the masked-max fast path) with
    no gradient; losses and metrics are empty without ``gt_depth``."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        model.eval()
        with torch.inference_mode():
            preds = model(batch["images"], batch["cams"], **model_kwargs)
            has_gt = "gt_depth" in batch
            losses = (loss_fn(preds, batch["gt_depth"], batch["cams"])
                      if loss_fn is not None and has_gt else {})
            metrics = (metric_fn(preds, batch["gt_depth"], batch["cams"])
                       if metric_fn is not None and has_gt else {})
        return preds, losses, metrics

    return step
