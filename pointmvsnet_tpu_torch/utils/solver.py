"""Optimizer and learning-rate schedule with optax semantics: counterpart of
``pointmvsnet_tpu/utils/solver.py``, whose chain is
``apply_if_finite(multi_transform({train: chain(add_decayed_weights(wd),
rmsprop(schedule)), frozen: set_to_zero}))``. Per step, for every
parameter that is not frozen:

    g ← g + wd · p                          (add_decayed_weights, first)
    RMSprop: ν ← α·ν + (1 − α)·g²,  u = g / √(ν + ε)   (ν₀ = 0, ε inside
             the root: optax's ``eps_in_sqrt=True``, not torch.optim.RMSprop)
    Adam:    optax.adam defaults (b1 0.9, b2 0.999, ε 1e-8, bias-corrected)
    SGD:     momentum 0.9 trace, t ← g + 0.9·t, u = t
    p ← p − lr(count) · u

``lr(count) = BASE_LR · γ^⌊count / (STEP_SIZE · steps_per_epoch)⌋``
(StepLR, staircase) over ``count``, the number of updates applied so far.
A parameter without a gradient (PointFlow's during the coarse-only epochs)
counts as a zero gradient, as JAX's does, so weight decay still moves it.
With ``SOLVER.SKIP_NONFINITE`` a step whose gradients hold a NaN or inf
changes neither parameters nor optimizer state (``apply_if_finite``);
after more than ``MAX_CONSECUTIVE_NONFINITE`` such steps in a row it
applies them, so the train loop aborts well before that.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping

import torch

from pointmvsnet_tpu_torch.utils.freezer import frozen_names

MAX_CONSECUTIVE_NONFINITE = 100


def build_lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    base = cfg.SOLVER.BASE_LR
    if cfg.SCHEDULER.TYPE == "StepLR":
        period = max(1, cfg.SCHEDULER.STEP_LR.STEP_SIZE * steps_per_epoch)
        gamma = cfg.SCHEDULER.STEP_LR.GAMMA
        return lambda count: base * gamma ** math.floor(count / period)
    if cfg.SCHEDULER.TYPE == "none":
        return lambda count: base
    raise ValueError(f"Unknown SCHEDULER.TYPE {cfg.SCHEDULER.TYPE!r}")


class Optimizer:
    """The update rule above over ``params`` (name → tensor, updated in
    place). ``step(grads)`` → True if the update was applied."""

    def __init__(self, params: Mapping[str, torch.Tensor], kind: str,
                 lr: Callable[[int], float], weight_decay: float = 0.0,
                 frozen=(), skip_nonfinite: bool = True, alpha: float = 0.9,
                 eps: float = 1e-8):
        if kind not in ("RMSprop", "Adam", "SGD"):
            raise ValueError(f"Unknown SOLVER.TYPE {kind!r}")
        self.params = dict(params)
        self.kind = kind
        self.lr = lr
        self.weight_decay = weight_decay
        self.frozen = frozen_names(self.params, frozen)
        self.skip_nonfinite = skip_nonfinite
        self.alpha, self.eps = alpha, eps
        self.count = 0                   # updates applied (the schedule's step)
        self.skipped_steps = 0           # non-finite steps skipped in all
        self.consecutive_skipped = 0
        slots = {"RMSprop": ("nu",), "Adam": ("mu", "nu"), "SGD": ("trace",)}[kind]
        self.slots = {n: {s: torch.zeros_like(p) for s in slots}
                      for n, p in self.params.items() if n not in self.frozen}

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> bool:
        if self.skip_nonfinite:
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads.values()]).all())
            if finite:
                self.consecutive_skipped = 0
            else:
                self.skipped_steps += 1
                self.consecutive_skipped += 1
                if self.consecutive_skipped <= MAX_CONSECUTIVE_NONFINITE:
                    return False
        lr = self.lr(self.count)
        for name, slot in self.slots.items():
            p = self.params[name]
            g = grads[name]
            if self.weight_decay > 0:
                g = g + self.weight_decay * p
            p.add_(self._direction(slot, g) * -lr)
        self.count += 1
        return True

    def _direction(self, slot: Dict[str, torch.Tensor], g: torch.Tensor) -> torch.Tensor:
        if self.kind == "RMSprop":
            slot["nu"] = (1 - self.alpha) * g.square() + self.alpha * slot["nu"]
            return g * torch.rsqrt(slot["nu"] + self.eps)
        if self.kind == "Adam":
            b1, b2, t = 0.9, 0.999, self.count + 1
            slot["mu"] = (1 - b1) * g + b1 * slot["mu"]
            slot["nu"] = (1 - b2) * g.square() + b2 * slot["nu"]
            mu_hat = slot["mu"] / (1 - b1 ** t)
            nu_hat = slot["nu"] / (1 - b2 ** t)
            return mu_hat / (nu_hat.sqrt() + 1e-8)
        slot["trace"] = g + 0.9 * slot["trace"]
        return slot["trace"]

    def state_dict(self) -> Dict:
        return {"count": self.count, "skipped_steps": self.skipped_steps,
                "consecutive_skipped": self.consecutive_skipped,
                "slots": {n: dict(s) for n, s in self.slots.items()}}

    def load_state_dict(self, sd: Mapping) -> None:
        if set(sd["slots"]) != set(self.slots):
            raise ValueError("optimizer state names do not match the parameters")
        self.count = int(sd["count"])
        self.skipped_steps = int(sd["skipped_steps"])
        self.consecutive_skipped = int(sd["consecutive_skipped"])
        for n, s in sd["slots"].items():
            for k, v in s.items():
                self.slots[n][k] = v.to(self.slots[n][k].device)


def build_optimizer(cfg, params: Mapping[str, torch.Tensor],
                    steps_per_epoch: int = 1) -> Optimizer:
    """cfg → the optimizer over ``params`` (``dict(model.named_parameters())``)."""
    return Optimizer(params, cfg.SOLVER.TYPE,
                     build_lr_schedule(cfg, steps_per_epoch),
                     weight_decay=cfg.SOLVER.WEIGHT_DECAY,
                     frozen=tuple(cfg.TRAIN.FROZEN_PATTERNS),
                     skip_nonfinite=cfg.SOLVER.SKIP_NONFINITE,
                     alpha=cfg.SOLVER.RMSPROP.ALPHA, eps=cfg.SOLVER.RMSPROP.EPS)
