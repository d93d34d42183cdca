"""MVSNet-format export of one evaluated view for the fusion stage: the
port's copy of ``pointmvsnet_tpu/utils/eval_file_logger.py``. Per reference
view, into ``<out>/scan<n>/``: the maps of ``maps`` (file suffix →
prediction key; by default Point-MVSNet's: the coarse depth
``*_init.pfm``, each PointFlow iteration's depth ``*_flowN.pfm``, the
coarse probability map ``*_prob.pfm``; a model's ``export_maps`` gives its
own), the camera scaled to the resolution of the depth fusion reads (the
last ``flowN``, else ``init``) (``*.txt``) and the reference image
stretched to 0-255 (``*.png``, by ``dataset/io.py::write_png``)."""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np

from pointmvsnet_tpu_torch.dataset.io import write_cam, write_pfm, write_png
from pointmvsnet_tpu_torch.dataset.preprocess import scale_camera


def eval_file_logger(batch: Dict[str, np.ndarray], preds: Dict[str, np.ndarray],
                     output_dir: str, batch_index: int = 0,
                     maps: Optional[Mapping[str, str]] = None) -> str:
    """Write one sample's files (numpy ``batch`` and ``preds``); → the scan
    directory."""
    i = batch_index
    scan = int(np.asarray(batch["scan"])[i])
    ref_view = int(np.asarray(batch["ref_view"])[i])
    images = np.asarray(batch["images"])[i]          # (V, H, W, 3)
    cams = np.asarray(batch["cams"])[i]              # (V, 2, 4, 4)
    h, w = images.shape[1:3]

    scan_dir = os.path.join(output_dir, f"scan{scan}")
    os.makedirs(scan_dir, exist_ok=True)
    stem = os.path.join(scan_dir, f"{ref_view:08d}")

    if maps is None:         # Point-MVSNet's: the coarse depth, each flow's, the probability
        flows = sorted(k for k in preds if k.startswith("flow") and not k.endswith("_input"))
        maps = {"init": "coarse_depth_map", **{k: k for k in flows}, "prob": "coarse_prob_map"}
    flows = [key for suffix, key in maps.items() if suffix.startswith("flow")]
    final_key = flows[-1] if flows else maps["init"]

    for suffix, key in maps.items():
        write_pfm(stem + f"_{suffix}.pfm", np.asarray(preds[key])[i].astype(np.float32))

    # the camera at the final depth map's resolution (what fusion reads)
    dh, dw = np.asarray(preds[final_key])[i].shape
    write_cam(stem + ".txt", scale_camera(cams[0], (dw / w, dh / h)))

    img = images[0]
    lo, hi = img.min(), img.max()
    write_png(stem + ".png", ((img - lo) / max(hi - lo, 1e-6) * 255).astype(np.uint8))
    return scan_dir
