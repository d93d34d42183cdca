"""Benchmark helpers: the port's counterparts of ``make_inputs``, ``build``
and ``measure`` in the JAX package's ``bench.py``, which
``benchmarks/tt_sweep.py`` imports.

The headline line of ``bench.py`` (its ``main``, the train-step and
per-stage details) comes with the port's benchmark; this module holds only
what the sweep needs. ``build`` leaves out ``bench.py``'s ``BENCH_*``
environment A/Bs: they select TPU engines that ``build_model`` rejects.
Everything runs on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import time

import torch

from pointmvsnet_tpu_torch import resolve_device
from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
from pointmvsnet_tpu_torch.models import build_model


def make_inputs(b, v, h, w, d, with_gt=False, device="cuda"):
    """The geometrically consistent synthetic scene of
    ``dataset/synthetic.py::make_scene_batch`` (textured planes rendered
    per view, per-image standardized, DTU-like cams) on ``device`` →
    (images (B, V, H, W, 3), cams (B, V, 2, 4, 4)[, gt (B, H, W, 1)])."""
    dev = resolve_device(device)
    images, cams, gt = make_scene_batch(b, v, h, w, d)
    out = (torch.tensor(images, device=dev), torch.tensor(cams, device=dev))
    if with_gt:
        out += (torch.tensor(gt[..., None], device=dev),)
    return out


def build(norm="bn", dtype="bfloat16", chunk_rows=None, fetch=None, device="cuda"):
    """The default config with ``norm``, ``dtype``, ``chunk_rows``
    (MODEL.FLOW_CHUNK_ROWS; None keeps the default) and ``fetch``
    (MODEL.FLOW_FETCH; None keeps the default) → (cfg, model in eval mode
    on ``device``). A fetch engine the port does not implement raises
    (``models.check_model_knobs``)."""
    cfg = get_default_cfg()
    cfg.MODEL.NORM = norm
    cfg.MODEL.DTYPE = dtype
    if chunk_rows is not None:
        cfg.MODEL.FLOW_CHUNK_ROWS = chunk_rows
    if fetch is not None:
        cfg.MODEL.FLOW_FETCH = fetch
    return cfg, build_model(cfg, device)


def measure(model, images, cams, kwargs, iters=15):
    """Sustained maps/s: a warm-up window, then the better of two timed
    windows, each ``iters`` back-to-back forwards under
    ``torch.inference_mode()`` closed by ONE synchronize, which bounds them
    all. The JAX version feeds each call a zero taken from the previous
    output so that the TPU runs them in order behind one host sync; on the
    card the stream already runs them in order. Raises if a window's last
    depth map is not finite. → (B / dt, dt), dt in seconds per forward."""
    def window():
        with torch.inference_mode():
            t0 = time.perf_counter()
            for _ in range(iters):
                out = model(images, cams, **kwargs)
            if images.is_cuda:
                torch.cuda.synchronize(images.device)
            dt = (time.perf_counter() - t0) / iters
        flows = sorted(k for k in out if k.startswith("flow") and not k.endswith("_input"))
        last = out[flows[-1] if flows else "coarse_depth_map"]
        if not bool(torch.isfinite(last).all()):
            raise FloatingPointError("measure: the last depth map is not finite")
        return dt

    window()
    dt = min(window(), window())
    return images.shape[0] / dt, dt
