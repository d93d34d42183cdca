"""Serving front end: counterpart of ``pointmvsnet_tpu/predictor.py``.

    pred = Predictor(cfg, weight_path="outputs/dtu_wde3/checkpoints")
    out = pred(images, cams)                 # numpy in → numpy out
    out["depth"], out["confidence"]

Same host-side preprocessing as the JAX package (center crop to multiples
of the model's ``crop_base``, 64 for Point-MVSNet, per-image
standardization); the model gives its eval options (``eval_kwargs``) and
the keys of its final depth and confidence (``result_keys``). The
weights: ``state_dict`` if given, else
``weight_path``, else the newest checkpoint of ``checkpoint_dir`` (each a
``.pt`` file, a directory of ``<epoch>.pt`` files or an orbax checkpoint
of the JAX package; ``utils/checkpoint.py::load_weights``), else drawn
from ``cfg.RNG_SEED`` (``utils.convert.init_params``). Runs on CUDA unless
``device="cpu"``, float32 without TF32 (``disable_tf32``). ``grid``: an
eval grid (``parallel.distributed.make_eval_grid``) whose band and view
groups share out each prediction; every rank of the group calls the
predictor with the same request and gets the same answer.

Under a profiler a call is four spans (``utils/profiler.py::span``):
``predictor.prepare`` (the host's crop and normalization),
``predictor.to_device``, ``predictor.model`` and ``predictor.to_host``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from pointmvsnet_tpu_torch import disable_tf32
from pointmvsnet_tpu_torch.dataset.preprocess import crop_mvs_input, norm_image
from pointmvsnet_tpu_torch.models import build_model
from pointmvsnet_tpu_torch.utils import profiler
from pointmvsnet_tpu_torch.utils.checkpoint import load_weights
from pointmvsnet_tpu_torch.utils.convert import init_params


class Predictor:
    def __init__(self, cfg, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 device="cuda", normalize: bool = True, checkpoint_dir: str = "",
                 weight_path: str = "", grid=None):
        self.cfg = cfg
        self.normalize = normalize
        self.model = build_model(cfg, device, grid)
        disable_tf32()
        self.device = next(self.model.parameters()).device
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        elif weight_path or checkpoint_dir:
            load_weights(self.model, weight_path or checkpoint_dir)
        else:
            self.model.load_state_dict(
                init_params(self.model, torch.Generator().manual_seed(cfg.RNG_SEED)))
        self.kwargs = self.model.eval_kwargs(cfg)

    def __call__(self, images: np.ndarray, cams: np.ndarray) -> Dict[str, np.ndarray]:
        """images (V, H, W, 3) float or uint8; cams (V, 2, 4, 4) → dict with
        ``depth`` (h, w), ``confidence`` (hc, wc) and every raw stage."""
        with profiler.span("predictor.prepare"):
            images = np.asarray(images, np.float32)
            cams = np.asarray(cams, np.float32)
            imgs, cms = crop_mvs_input(list(images), list(cams),
                                       images.shape[1], images.shape[2],
                                       base=self.model.crop_base)
            if self.normalize:
                imgs = [norm_image(im) for im in imgs]
            imgs, cms = np.stack(imgs)[None], np.stack(cms)[None]
        with profiler.span("predictor.to_device"):
            batch_imgs = torch.from_numpy(imgs).to(self.device)
            batch_cams = torch.from_numpy(cms).to(self.device)
        with torch.inference_mode():
            with profiler.span("predictor.model"):
                preds = self.model(batch_imgs, batch_cams, **self.kwargs)
            with profiler.span("predictor.to_host"):
                preds = {k: v[0].float().cpu().numpy() for k, v in preds.items()}
                depth, confidence = self.model.result_keys(preds)
                preds["depth"], preds["confidence"] = preds[depth], preds[confidence]
        return preds
