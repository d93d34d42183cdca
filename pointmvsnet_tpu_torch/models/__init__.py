"""Model registry and ``build_model``: counterpart of
``pointmvsnet_tpu/models/__init__.py``.

``build_model`` rejects the JAX package's TPU-only knobs when they are set
away from a value whose meaning the port implements, instead of quietly
reinterpreting them. ``MODEL.FLOW_CHUNK_ROWS`` takes any band height ≥ -1;
-1, the JAX package's AUTO height for the TPU's VMEM, is unbanded here.
Where the JAX package's build functions return the triple (model,
loss_fn, metric_fn), the port's return the model, and ``build_loss_fn`` /
``build_metric_fn`` give the other two, as ``register_model`` recorded
them beside the builder.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import torch

from pointmvsnet_tpu_torch import resolve_device
from pointmvsnet_tpu_torch.models.casmvsnet import CasMVSNet
from pointmvsnet_tpu_torch.models.edge_conv import EdgeConv
from pointmvsnet_tpu_torch.models.image_conv import ImageConv
from pointmvsnet_tpu_torch.models.loss import (
    cascade_loss,
    cascade_metrics,
    pointmvsnet_loss,
    pointmvsnet_metrics,
)
from pointmvsnet_tpu_torch.models.pointmvsnet import PointFlow, PointMVSNet
from pointmvsnet_tpu_torch.models.volume_conv import VolumeConv

MODEL_REGISTRY: Dict[str, Callable] = {}
# MODEL.NAME → (cfg → its loss_fn, its metric_fn), from ``register_model``
_HEADS: Dict[str, Tuple[Callable, Callable]] = {}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# MODEL.<key> → the values the port implements. "auto" fetch is per-level
# bilinear and "auto" moments are on, which is what the port runs.
_ACCEPTED = {
    "KNN_IMPL": ("auto",),
    "FLOW_FETCH": ("auto", "bilinear"),
    "COARSE_FETCH": ("mxu",),
    "FLOW_MOMENTS": ("auto", "on", True),
    "FLOW_SRC_DTYPE": ("",),
    "REMAT": (False,),
}


def check_model_knobs(cfg) -> None:
    for key, ok in _ACCEPTED.items():
        val = cfg.MODEL[key]
        if not any(val == o and type(val) is type(o) for o in ok):
            raise ValueError(
                f"MODEL.{key}={val!r} selects a TPU engine of the JAX package; "
                f"the port implements {ok}")
    cr = cfg.MODEL.FLOW_CHUNK_ROWS
    if type(cr) is not int or cr < -1:
        raise ValueError(f"MODEL.FLOW_CHUNK_ROWS={cr!r}: want a band height, 0 or -1 "
                         f"(both unbanded)")


def _pointmvsnet_loss_fn(cfg) -> Callable:
    return functools.partial(
        pointmvsnet_loss,
        valid_threshold=cfg.MODEL.VALID_THRESHOLD if cfg.MODEL.MASKED_LOSS else 0.0)


def register_model(name: str, loss_fn: Callable = _pointmvsnet_loss_fn,
                   metric_fn: Callable = pointmvsnet_metrics):
    """Register a builder under ``name``, with ``loss_fn`` (cfg → the
    model's ``loss(preds, gt_depth, cams)``) and its ``metric_fn``."""
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        _HEADS[name] = (loss_fn, metric_fn)
        return fn
    return deco


@register_model("pointmvsnet")
def build_pointmvsnet(cfg, band_group=None, view_group=None) -> PointMVSNet:
    """``band_group`` / ``view_group``: the process groups that share out
    one map's flow bands (PARALLEL.BAND) and its cost volume's views
    (PARALLEL.VIEW), or None."""
    check_model_knobs(cfg)
    return PointMVSNet(
        img_base_channels=cfg.MODEL.IMG_BASE_CHANNELS,
        vol_base_channels=cfg.MODEL.VOL_BASE_CHANNELS,
        edge_channels=tuple(cfg.MODEL.EDGE_CHANNELS),
        flow_channels=tuple(cfg.MODEL.FLOW_CHANNELS),
        flow_m=cfg.MODEL.FLOW_INTERVAL_M,
        knn=cfg.MODEL.KNN,
        knn_window=cfg.MODEL.KNN_WINDOW,
        norm=cfg.MODEL.NORM,
        dtype=_DTYPES[cfg.MODEL.DTYPE],
        flow_chunk_rows=cfg.MODEL.FLOW_CHUNK_ROWS,
        band_group=band_group,
        view_group=view_group,
    )


@register_model("mvsnet")
def build_mvsnet(cfg, band_group=None, view_group=None) -> PointMVSNet:
    """Coarse-only family: the same model, run with ``is_flow=False``."""
    model = build_pointmvsnet(cfg, band_group, view_group)
    model.coarse_only = True
    return model


@register_model("casmvsnet", loss_fn=lambda cfg: cascade_loss, metric_fn=cascade_metrics)
def build_casmvsnet(cfg, band_group=None, view_group=None) -> CasMVSNet:
    """CasMVSNet (eval): ``MODEL.CASCADE``'s depths and interval ratios per
    stage, ``IMG_BASE_CHANNELS`` for the feature net, ``VOL_BASE_CHANNELS``
    for each stage's U-Net."""
    check_model_knobs(cfg)
    if band_group is not None or view_group is not None:
        raise ValueError("casmvsnet has no band- or view-parallel eval: PARALLEL.BAND "
                         "and PARALLEL.VIEW must be 1")
    c = cfg.MODEL.CASCADE
    return CasMVSNet(img_base_channels=cfg.MODEL.IMG_BASE_CHANNELS,
                     vol_base_channels=cfg.MODEL.VOL_BASE_CHANNELS,
                     ndepths=tuple(c.NDEPTHS), interval_ratios=tuple(c.DEPTH_INTERVAL_RATIOS),
                     norm=cfg.MODEL.NORM, dtype=_DTYPES[cfg.MODEL.DTYPE])


def build_loss_fn(cfg) -> Callable:
    """cfg → ``loss_fn(preds, gt_depth, cams)`` of ``MODEL.NAME``:
    Point-MVSNet's, with the flow iterations' reach mask at
    ``MODEL.VALID_THRESHOLD`` when ``MODEL.MASKED_LOSS``; CasMVSNet's."""
    return _HEADS[cfg.MODEL.NAME][0](cfg)


def build_metric_fn(cfg) -> Callable:
    """cfg → ``metric_fn(preds, gt_depth, cams)`` of ``MODEL.NAME``: the
    share of valid pixels within 1 and 3 depth intervals, per stage."""
    return _HEADS[cfg.MODEL.NAME][1]


def build_model(cfg, device="cuda", grid=None) -> torch.nn.Module:
    """cfg → the model on ``device`` (CUDA unless the caller asks for the
    CPU; raises without a GPU), in eval mode; the train step switches it to
    training mode. ``grid``: this rank's ``parallel.distributed.EvalGrid``,
    whose band and view groups the model's eval forward shares its work
    over (the JAX package's ``band_mesh`` / ``view_mesh``)."""
    dev = resolve_device(device)
    name = cfg.MODEL.NAME
    if name not in MODEL_REGISTRY:
        raise KeyError(f"Unknown MODEL.NAME {name!r}; have {sorted(MODEL_REGISTRY)}")
    groups = (grid.band_group, grid.view_group) if grid is not None else (None, None)
    return MODEL_REGISTRY[name](cfg, *groups).to(dev).eval()


__all__ = ["PointMVSNet", "PointFlow", "CasMVSNet", "ImageConv", "VolumeConv", "EdgeConv",
           "pointmvsnet_loss", "pointmvsnet_metrics", "build_loss_fn",
           "build_model", "build_pointmvsnet", "build_mvsnet", "build_casmvsnet",
           "build_metric_fn", "MODEL_REGISTRY",
           "register_model", "check_model_knobs"]
