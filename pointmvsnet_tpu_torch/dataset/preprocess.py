"""Image/camera preprocessing: the port's numpy-only copy of
``pointmvsnet_tpu/dataset/preprocess.py :: norm_image, scale_camera,
scale_image, scale_mvs_input, crop_mvs_input, mask_depth_image`` and of
the nearest and linear cases of ``resize_image``, with cv2's
``INTER_NEAREST`` / ``INTER_LINEAR`` semantics (no cv2). ``resize_image``
defaults to the nearest rule, which the training split uses for depth;
the JAX package defaults to linear. The linear case runs in the port's
C++ library (``native``) unless ``PMVS_NO_NATIVE`` is set, bit-equal to
its numpy version ``_resize_linear_py``."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from pointmvsnet_tpu_torch.dataset.io import _native


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


def _linear_taps(n_out: int, n_in: int):
    """cv2's INTER_LINEAR taps along one axis: source coordinate
    (i + 0.5) / (n_out / n_in) − 0.5 and its fraction in double precision,
    clamped to the edges → (i0, i1, weight of i0, weight of i1), the
    weights rounded to float32."""
    t = (np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
    i0 = np.floor(t).astype(np.int64)
    f = t - i0
    f[i0 < 0] = 0
    i0 = np.maximum(i0, 0)
    f[i0 >= n_in - 1] = 0
    i0 = np.minimum(i0, n_in - 1)
    return i0, np.minimum(i0 + 1, n_in - 1), (1 - f).astype(np.float32), f.astype(np.float32)


def resize_image(img: np.ndarray, shape_hw: Tuple[int, int],
                 interpolation: str = "nearest") -> np.ndarray:
    """Resize to (h, w) as ``cv2.resize(img, (w, h), interpolation=...)``.

    ``"nearest"``: source index floor(i · (1 / (n_out / n_in))) in double
    precision, clamped to the last row / column (equal to cv2).
    ``"linear"``: two taps per axis at the pixel-centre-aligned source
    coordinate, clamped at the edges, no antialiasing; rows first, then
    columns, in float32. Float input gives float32 out; uint8 input is
    rounded half up to uint8 (cv2 rounds through 11-bit fixed-point
    weights, so uint8 results may differ from it by one level)."""
    nh, nw = shape_hw
    h, w = img.shape[:2]
    if interpolation == "nearest":
        def src(n_out, n_in):
            inv = 1.0 / (n_out / n_in)
            return np.minimum(np.floor(np.arange(n_out) * inv).astype(np.int64), n_in - 1)

        return img[src(nh, h)][:, src(nw, w)]
    if interpolation != "linear":
        raise ValueError(f"interpolation {interpolation!r}: want 'nearest' or 'linear'")
    taps_x = _linear_taps(nw, w)
    taps_y = _linear_taps(nh, h)
    n = _native()
    if n:
        return n.resize_linear(img, taps_y, taps_x)
    return _resize_linear_py(img, taps_y, taps_x)


def _resize_linear_py(img: np.ndarray, taps_y, taps_x) -> np.ndarray:
    """``resize_image(..., "linear")`` in numpy: the plain version of the C
    path, and the PMVS_NO_NATIVE path."""
    x = np.asarray(img, np.float32)
    (y0, y1, ay0, ay1), (x0, x1, ax0, ax1) = taps_y, taps_x
    col = (None, slice(None)) + (None,) * (x.ndim - 2)      # weights along w
    row = (slice(None),) + (None,) * (x.ndim - 1)           # weights along h
    rows = x[:, x0] * ax0[col] + x[:, x1] * ax1[col]
    out = rows[y0] * ay0[row] + rows[y1] * ay1[row]
    if img.dtype == np.uint8:
        return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
    return out.astype(np.float32)


def scale_image(img: np.ndarray, scale: float, interpolation: str = "linear") -> np.ndarray:
    """Resize by ``scale`` to (int(round(h·s)), int(round(w·s)))."""
    h, w = img.shape[:2]
    return resize_image(img, (int(round(h * scale)), int(round(w * scale))), interpolation)


def scale_mvs_input(images: Sequence[np.ndarray], cams: Sequence[np.ndarray],
                    scale: float) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Scale every view's image (linear) and intrinsics by ``scale``."""
    return [scale_image(im, scale) for im in images], [scale_camera(c, scale) for c in cams]
