"""Plain reference of Point-MVSNet's training step: the masked L1 depth
loss in depth-interval units over the coarse map and every flow
iteration, and RMSprop with optax's semantics (weight decay added to the
gradient first; ν ← α·ν + (1 − α)·g², u = g / √(ν + ε)). Imports nothing
of the measured program."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference.model import cam_depth_range, flow_keys


def depth_loss(preds: Dict[str, torch.Tensor], gt_depth: torch.Tensor, cams: torch.Tensor,
               valid_threshold: float) -> Dict[str, torch.Tensor]:
    """Per-output masked mean |pred − gt| / interval and ``total_loss``. A
    flow iteration counts only pixels whose GT lies within
    ``valid_threshold`` intervals of its input depth (0: no such mask).
    gt_depth (B, H, W, 1), zeros invalid; GT is resized to each output by
    nearest-exact."""
    gt = gt_depth[..., 0]
    _, d_int, _, _ = cam_depth_range(cams[:, 0])
    inv = 1.0 / d_int[:, None, None]
    out, total = {}, 0.0
    for key in ["coarse_depth_map"] + flow_keys(preds):
        pred = preds[key]
        g = F.interpolate(gt[:, None], pred.shape[1:], mode="nearest-exact")[:, 0]
        mask = g > 0
        if valid_threshold > 0 and key + "_input" in preds:
            mask = mask & ((preds[key + "_input"] - g).abs() * inv < valid_threshold)
        err = (pred - g).abs() * inv
        loss = torch.where(mask, err, 0.0).sum() / mask.sum().to(err.dtype).clamp_min(1.0)
        out["coarse_loss" if key == "coarse_depth_map" else f"{key}_loss"] = loss
        total = total + loss
    out["total_loss"] = total
    return out


class RMSprop:
    """optax ``chain(add_decayed_weights(wd), rmsprop(lr))`` over a
    model's parameters, updated in place."""

    def __init__(self, model: torch.nn.Module, lr: float, weight_decay: float,
                 alpha: float, eps: float):
        self.params = dict(model.named_parameters())
        self.lr, self.wd, self.alpha, self.eps = lr, weight_decay, alpha, eps
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}

    @torch.no_grad()
    def step(self) -> None:
        for n, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            g = g + self.wd * p
            self.nu[n] = (1 - self.alpha) * g.square() + self.alpha * self.nu[n]
            p.add_(g * torch.rsqrt(self.nu[n] + self.eps) * -self.lr)


def train_step(model, opt: RMSprop, batch: Dict[str, torch.Tensor], model_kwargs: Dict,
               valid_threshold: float) -> Dict[str, torch.Tensor]:
    """Forward in training mode, loss, backward, RMSprop → detached losses."""
    model.train()
    model.zero_grad(set_to_none=True)
    preds = model(batch["images"], batch["cams"], **model_kwargs)
    losses = depth_loss(preds, batch["gt_depth"], batch["cams"], valid_threshold)
    losses["total_loss"].backward()
    opt.step()
    return {k: v.detach() for k, v in losses.items()}
