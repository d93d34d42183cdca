"""Loss and metrics of Point-MVSNet: counterpart of
``pointmvsnet_tpu/models/loss.py``.

The loss is the masked mean absolute depth error in depth-interval units,
summed over the coarse map and every flow iteration; the metrics are the
fraction of valid pixels within 1 and 3 intervals of the ground truth.
Ground truth is resized to each output by ``nearest-exact``, which equals
the JAX package's ``jax.image.resize(method="nearest")`` (``nearest``
does not). Masked means divide by max(count, 1), so an empty mask gives 0
and no NaN.

With ``sharded`` the batch is this rank's rows of a global batch (the
train and validation steps under data parallelism): each masked mean is
then the local masked sum over the count of the *global* batch, as the
JAX package's mean over its sharded batch is, so the ranks' values sum to
the global loss and the sum of their gradients is its gradient. A mean of
per-rank means would be another loss. ``group``: the ranks that share the
global batch (on an eval grid, a data group), default every rank.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from pointmvsnet_tpu_torch.ops.geometry import cam_depth_range
from pointmvsnet_tpu_torch.parallel import distributed


def _resize_gt(gt: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """GT depth (B, H, W) → (B, h, w), nearest (zeros must stay exact)."""
    return F.interpolate(gt[:, None], (h, w), mode="nearest-exact")[:, 0]


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, sharded: bool,
                 group=None) -> torch.Tensor:
    count = mask.sum().to(x.dtype)
    if sharded:
        count = distributed.all_reduce_sum_(count, group)
    return torch.where(mask, x, 0.0).sum() / count.clamp_min(1.0)


def _stages(preds: Dict[str, torch.Tensor]):
    """The depth outputs: the coarse map, then flow1, flow2, ... by name."""
    return ["coarse_depth_map"] + sorted(
        k for k in preds if k.startswith("flow") and not k.endswith("_input"))


def pointmvsnet_loss(preds: Dict[str, torch.Tensor], gt_depth: torch.Tensor,
                     cams: torch.Tensor,
                     valid_threshold: float = 0.0,
                     sharded: bool = False, group=None) -> Dict[str, torch.Tensor]:
    """Per-output masked MAE in interval units and ``total_loss``, their
    sum. With ``valid_threshold`` > 0 each flow iteration only counts pixels
    whose GT lies within ``valid_threshold`` intervals of that iteration's
    input depth (``preds["flowN_input"]``): PointFlow moves a depth by at
    most m steps. gt_depth (B, H, W, 1) at image resolution, zeros invalid."""
    gt = gt_depth[..., 0]
    _, d_int, _, _ = cam_depth_range(cams[:, 0])
    inv_int = 1.0 / d_int[:, None, None]
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    for key in _stages(preds):
        pred = preds[key]
        g = _resize_gt(gt, pred.shape[1], pred.shape[2])
        mask = g > 0
        if valid_threshold > 0 and key + "_input" in preds:
            reach = (preds[key + "_input"] - g).abs() * inv_int
            mask = mask & (reach < valid_threshold)
        err = (pred - g).abs() * inv_int
        name = "coarse_loss" if key == "coarse_depth_map" else f"{key}_loss"
        losses[name] = _masked_mean(err, mask, sharded, group)
        total = total + losses[name]
    losses["total_loss"] = total
    return losses


def pointmvsnet_metrics(preds: Dict[str, torch.Tensor], gt_depth: torch.Tensor,
                        cams: torch.Tensor,
                        thresholds: Sequence[float] = (1.0, 3.0),
                        sharded: bool = False, group=None) -> Dict[str, torch.Tensor]:
    """``<{t}_pct_{stage}``: fraction of valid pixels whose error is below
    t intervals, stage ``cor`` for the coarse map and ``flowN``."""
    gt = gt_depth[..., 0]
    _, d_int, _, _ = cam_depth_range(cams[:, 0])
    interval = d_int[:, None, None]
    out: Dict[str, torch.Tensor] = {}
    for key in _stages(preds):
        pred = preds[key]
        g = _resize_gt(gt, pred.shape[1], pred.shape[2])
        mask = g > 0
        err = (pred - g).abs()
        stage = "cor" if key == "coarse_depth_map" else key
        for t in thresholds:
            out[f"<{int(t)}_pct_{stage}"] = _masked_mean((err < t * interval).float(), mask,
                                                            sharded, group)
    return out
