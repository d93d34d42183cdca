"""Loss and metrics of Point-MVSNet: counterpart of
``pointmvsnet_tpu/models/loss.py``; and CasMVSNet's loss
(``cascade_loss``), which the JAX package has not.

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

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from pointmvsnet_tpu_torch.models.pointmvsnet import flow_keys
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
    return ["coarse_depth_map"] + flow_keys(preds)


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
                        sharded: bool = False, group=None,
                        stages: Optional[Dict[str, str]] = None) -> Dict[str, torch.Tensor]:
    """``<{t}_pct_{stage}``: fraction of valid pixels whose error is below
    t intervals, stage ``cor`` for the coarse map and ``flowN``; or, with
    ``stages`` (prediction key → stage name), those stages."""
    gt = gt_depth[..., 0]
    _, d_int, _, _ = cam_depth_range(cams[:, 0])
    interval = d_int[:, None, None]
    out: Dict[str, torch.Tensor] = {}
    if stages is None:
        stages = {k: "cor" if k == "coarse_depth_map" else k for k in _stages(preds)}
    for key, stage in stages.items():
        pred = preds[key]
        g = _resize_gt(gt, pred.shape[1], pred.shape[2])
        mask = g > 0
        err = (pred - g).abs()
        for t in thresholds:
            out[f"<{int(t)}_pct_{stage}"] = _masked_mean((err < t * interval).float(), mask,
                                                            sharded, group)
    return out


CASCADE_STAGES = {f"stage{s}_depth": f"stage{s}" for s in (1, 2, 3)}
CASCADE_LOSS_WEIGHTS = (0.5, 1.0, 2.0)     # the published stages' weights


def cascade_loss(preds: Dict[str, torch.Tensor], gt_depth: torch.Tensor,
                 cams: torch.Tensor, sharded: bool = False,
                 group=None) -> Dict[str, torch.Tensor]:
    """CasMVSNet's loss: per stage the masked mean smooth-L1 (β = 1, in the
    depth's units) against the GT resized to the stage's grid, and
    ``total_loss``, their sum weighted by ``CASCADE_LOSS_WEIGHTS``.
    gt_depth (B, H, W, 1) at image resolution, zeros invalid."""
    gt = gt_depth[..., 0]
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    for (key, stage), wt in zip(CASCADE_STAGES.items(), CASCADE_LOSS_WEIGHTS):
        pred = preds[key]
        g = _resize_gt(gt, pred.shape[1], pred.shape[2])
        err = F.smooth_l1_loss(pred, g, reduction="none", beta=1.0)
        losses[f"{stage}_loss"] = _masked_mean(err, g > 0, sharded, group)
        total = total + wt * losses[f"{stage}_loss"]
    losses["total_loss"] = total
    return losses


def cascade_metrics(preds: Dict[str, torch.Tensor], gt_depth: torch.Tensor,
                    cams: torch.Tensor, **kwargs) -> Dict[str, torch.Tensor]:
    """``pointmvsnet_metrics`` over CasMVSNet's three stages."""
    return pointmvsnet_metrics(preds, gt_depth, cams, stages=CASCADE_STAGES, **kwargs)
