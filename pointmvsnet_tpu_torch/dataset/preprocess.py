"""Image/camera preprocessing: the port's numpy-only copy of
``pointmvsnet_tpu/dataset/preprocess.py :: norm_image, scale_camera,
crop_mvs_input, mask_depth_image`` and the nearest-neighbour case of
``resize_image`` (no cv2)."""

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


def mask_depth_image(depth: np.ndarray, min_depth: float, max_depth: float) -> np.ndarray:
    """Zero out depth outside [min, max] (zeros mark invalid pixels)."""
    out = np.where((depth >= min_depth) & (depth <= max_depth), depth, 0.0)
    return out.astype(np.float32)


def resize_image(img: np.ndarray, shape_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize to (h, w), equal to ``cv2.resize(img, (w, h),
    interpolation=cv2.INTER_NEAREST)``: source index floor(i · (1 / (n_out /
    n_in))) in double precision, clamped to the last row / column."""
    nh, nw = shape_hw
    h, w = img.shape[:2]

    def src(n_out, n_in):
        inv = 1.0 / (n_out / n_in)
        return np.minimum(np.floor(np.arange(n_out) * inv).astype(np.int64), n_in - 1)

    return img[src(nh, h)][:, src(nw, w)]
