"""Image/camera preprocessing for the serving path: the port's numpy-only
copy of ``pointmvsnet_tpu/dataset/preprocess.py :: norm_image,
scale_camera, crop_mvs_input`` (no cv2)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def norm_image(img: np.ndarray) -> np.ndarray:
    """Per-image, per-channel standardization over H×W: (x − mean) / (std + 1e-7)
    (MVSNet ``center_image``)."""
    img = np.asarray(img, dtype=np.float32)
    mean = img.mean(axis=(0, 1), keepdims=True)
    var = img.var(axis=(0, 1), keepdims=True)
    return (img - mean) / (np.sqrt(var) + 1e-7)


def scale_camera(cam: np.ndarray, scale: float | Tuple[float, float]) -> np.ndarray:
    """Scale intrinsics for an image resize by ``scale`` (sx, sy): fx, s, cx
    by sx; fy, cy by sy. Extrinsics and depth range untouched."""
    sx, sy = (scale, scale) if np.isscalar(scale) else scale
    out = cam.copy()
    out[1, 0, :3] = cam[1, 0, :3] * sx
    out[1, 1, :3] = cam[1, 1, :3] * sy
    return out


def crop_mvs_input(images: Sequence[np.ndarray], cams: Sequence[np.ndarray],
                   max_h: int, max_w: int, base: int = 64):
    """Center-crop every view to ``base``-divisible dims ≤ (max_h, max_w),
    shifting the principal points to match."""
    h, w = images[0].shape[:2]
    new_h = min(max_h, h) // base * base
    new_w = min(max_w, w) // base * base
    start_h = (h - new_h) // 2
    start_w = (w - new_w) // 2
    out_imgs, out_cams = [], []
    for im, cam in zip(images, cams):
        out_imgs.append(im[start_h:start_h + new_h, start_w:start_w + new_w])
        c = cam.copy()
        c[1, 0, 2] -= start_w
        c[1, 1, 2] -= start_h
        out_cams.append(c)
    return out_imgs, out_cams
