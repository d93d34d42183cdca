"""Multi-view depth-map fusion, MVSNet protocol, in numpy: the port's copy of
``pointmvsnet_tpu/postprocess/fusion.py``.

1. probability filter: ``prob > prob_threshold``;
2. geometric consistency of reference pixel p (depth d) against view j:
   project into j, sample j's depth (nearest, round half to even),
   reproject back → pixel p'' and depth d''; consistent iff
   ``|p'' − p| < pix_threshold`` and ``|d'' − d| / d < depth_threshold``;
3. keep pixels consistent in ≥ ``min_views`` source views; the fused
   depth is the mean of d and the consistent views' reprojected depths;
4. unproject to world points (with the reference image's colours).

Per-source work is vectorised over the reference view's valid pixels;
reference views run one after another. The JAX package fans them out
over a thread pool, and there concurrent (N, 3)·(3, 3) float32 matmuls
return wrong products now and then (numpy 2.0.2 with its bundled
OpenBLAS 0.3.27, 5 views of 640×512): a run drops or moves a few hundred
of 1.6 M points, differently each time. Run serially, it gives the same
points in every run, bit-equal to the torch twin's on the CPU on the same
maps. Per-view shapes may differ. For uniform
shapes ``fusion_torch.fuse_depth_maps_torch`` runs the same protocol for
all reference views at once on the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _project(points: np.ndarray, cam: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """world (N, 3) → pixel (N, 2), z (N,) for cam (2, 4, 4)."""
    e, k = cam[0], cam[1, :3, :3]
    pc = points @ e[:3, :3].T + e[:3, 3]
    uvw = pc @ k.T
    z = uvw[:, 2]
    safe = np.where(np.abs(z) < 1e-9, 1e-9, z)
    return uvw[:, :2] / safe[:, None], z


def _unproject(uv: np.ndarray, depth: np.ndarray, cam: np.ndarray) -> np.ndarray:
    """pixel (N, 2) + z-depth (N,) → world (N, 3)."""
    e, k = cam[0], cam[1, :3, :3]
    ones = np.ones((uv.shape[0], 1), uv.dtype)
    pc = (np.concatenate([uv, ones], 1) @ np.linalg.inv(k).T) * depth[:, None]
    return (pc - e[:3, 3]) @ e[:3, :3]


def _sample_nearest(img: np.ndarray, uv: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    h, w = img.shape[:2]
    x = np.round(uv[:, 0]).astype(np.int64)
    y = np.round(uv[:, 1]).astype(np.int64)
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    xc = np.clip(x, 0, w - 1)
    yc = np.clip(y, 0, h - 1)
    return img[yc, xc], inside


def _fuse_ref(ref: int, depths: Sequence[np.ndarray],
              cams: Sequence[np.ndarray],
              probs: Optional[Sequence[np.ndarray]],
              images: Optional[Sequence[np.ndarray]],
              src_list: List[int], prob_threshold: float,
              pix_threshold: float, depth_threshold: float,
              min_views: int):
    """Consistency-filter + fuse one reference view.

    → (points (M, 3), colors (M, 3) uint8 or None), possibly empty.

    The per-source work stays a Python loop of (N, 3)·(3, 3) matmuls on
    purpose: BLAS gemms beat einsum's batched path ~7× here, and per-view
    shapes may differ (T&T mixed resolutions)."""
    d = np.asarray(depths[ref], np.float32)
    h, w = d.shape
    valid = d > 0
    if probs is not None:
        valid &= np.asarray(probs[ref]) > prob_threshold
    if not valid.any() or not src_list:
        return None
    ys, xs = np.nonzero(valid)
    uv = np.stack([xs, ys], 1).astype(np.float32)
    dv = d[ys, xs]
    world = _unproject(uv, dv, cams[ref])

    n_consistent = np.zeros(len(dv), np.int32)
    depth_sum = dv.copy()
    for j in src_list:
        dj = np.asarray(depths[j], np.float32)
        hj, wj = dj.shape
        uv_j, z_j = _project(world, cams[j])
        dsamp, inside = _sample_nearest(dj, uv_j)
        ok = inside & (dsamp > 0) & (z_j > 0)
        if not ok.any():
            continue
        # reproject the src-view estimate back into the ref view
        world_j = _unproject(uv_j, dsamp, cams[j])
        uv_back, z_back = _project(world_j, cams[ref])
        pix_err = np.linalg.norm(uv_back - uv, axis=1)
        rel_d = np.abs(z_back - dv) / np.maximum(dv, 1e-9)
        cons = ok & (pix_err < pix_threshold) & (rel_d < depth_threshold)
        n_consistent += cons
        depth_sum = np.where(cons, depth_sum + z_back, depth_sum)

    keep = n_consistent >= min_views
    if not keep.any():
        return None
    fused_depth = (depth_sum[keep] / (n_consistent[keep] + 1)).astype(np.float32)
    pts = _unproject(uv[keep], fused_depth, cams[ref])
    cols = None
    if images is not None:
        img = np.asarray(images[ref])
        if img.max() <= 1.0 + 1e-6:
            img = img * 255.0
        cols = img[ys[keep], xs[keep]].astype(np.uint8)
    return pts, cols


def fuse_depth_maps(depths: Sequence[np.ndarray], cams: Sequence[np.ndarray],
                    probs: Optional[Sequence[np.ndarray]] = None,
                    images: Optional[Sequence[np.ndarray]] = None,
                    pairs: Optional[Dict[int, List[int]]] = None,
                    prob_threshold: float = 0.8,
                    pix_threshold: float = 1.0,
                    depth_threshold: float = 0.01,
                    min_views: int = 3) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """→ (points (N, 3), colors (N, 3) or None).

    depths[i]: (h, w); cams[i]: (2, 4, 4) at depth-map resolution;
    probs[i]: (h, w) confidence (optional); images[i]: (h, w, 3) in [0, 1]
    or [0, 255]; pairs: {ref: [src...]} view graph (default: all others).
    """
    nviews = len(depths)
    results = []
    for ref in range(nviews):
        src_list = pairs[ref] if pairs is not None else \
            [j for j in range(nviews) if j != ref]
        results.append(_fuse_ref(ref, depths, cams, probs, images, list(src_list),
                                 prob_threshold, pix_threshold, depth_threshold,
                                 min_views))

    all_pts = [r[0] for r in results if r is not None]
    all_cols = [r[1] for r in results if r is not None and r[1] is not None]
    if not all_pts:
        return np.zeros((0, 3), np.float32), None
    points = np.concatenate(all_pts, 0)
    colors = np.concatenate(all_cols, 0) if all_cols else None
    return points, colors
