"""Point-cloud accuracy / completeness (DTU protocol style): the port's copy
of ``pointmvsnet_tpu/postprocess/metrics.py``, nearest neighbours by
``scipy.spatial.cKDTree``, each search bounded by ``max_dist``.

Accuracy = mean distance from predicted points to the GT cloud,
completeness = mean distance from GT points to the prediction, each over
the distances below ``max_dist``; overall = their mean. The DTU eval
release's two mask steps apply when given: ``obs_mask=(mask, bb_min,
res)`` drops predicted points outside the occupied cells of the
observability grid (cell = floor((p − bb_min) / res)), ``gt_plane`` drops
GT points below the ground plane (plane·[p, 1] ≤ 0). Without them the
numbers are the unmasked core of the protocol, comparable across runs of
this repository but not to the paper's table.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _nn_dist(src: np.ndarray, dst: np.ndarray, max_dist: float) -> np.ndarray:
    """For each src point, distance to its nearest dst point, inf where
    none is within ``max_dist``. The bound changes no metric (distances
    beyond it are discarded) but stops each search there: a cloud lying
    off a planar one, tens of units away, otherwise costs a search of
    most of the tree per point (minutes at 1.6 M points)."""
    from scipy.spatial import cKDTree
    tree = cKDTree(dst)
    d, _ = tree.query(src, k=1, distance_upper_bound=max_dist)
    return np.asarray(d, np.float32)


def apply_obs_mask(points: np.ndarray,
                   obs_mask: Tuple[np.ndarray, np.ndarray, float]
                   ) -> np.ndarray:
    """Keep points inside occupied cells of a DTU observability grid.

    obs_mask = (mask (X, Y, Z) bool, bb_min (3,), res) — the structure of
    the eval release's ``ObsMask{scan}_10.mat``. → boolean keep mask (N,).
    """
    mask, bb_min, res = obs_mask
    idx = np.floor((points - np.asarray(bb_min, np.float32)) / res).astype(np.int64)
    inb = ((idx >= 0) & (idx < np.asarray(mask.shape))).all(axis=1)
    keep = np.zeros(len(points), bool)
    keep[inb] = mask[idx[inb, 0], idx[inb, 1], idx[inb, 2]]
    return keep


def apply_plane_mask(points: np.ndarray, plane: np.ndarray) -> np.ndarray:
    """Keep points above the ground plane: plane·[p, 1] > 0. → (N,) bool."""
    plane = np.asarray(plane, np.float32).reshape(4)
    return points @ plane[:3] + plane[3] > 0


def point_cloud_metrics(pred: np.ndarray, gt: np.ndarray,
                        max_dist: float = 20.0,
                        obs_mask: Optional[Tuple[np.ndarray, np.ndarray, float]] = None,
                        gt_plane: Optional[np.ndarray] = None) -> Dict[str, float]:
    """→ {accuracy, completeness, overall} in scene units (mm for DTU).

    ``max_dist``: DTU-protocol outlier threshold — distances beyond it are
    discarded from the mean (official eval uses 20 mm). ``obs_mask`` /
    ``gt_plane``: optional DTU observability masks (see module docstring).
    """
    pred = np.asarray(pred, np.float32)
    gt = np.asarray(gt, np.float32)
    if obs_mask is not None and len(pred):
        pred = pred[apply_obs_mask(pred, obs_mask)]
    if gt_plane is not None and len(gt):
        gt = gt[apply_plane_mask(gt, gt_plane)]
    if len(pred) == 0 or len(gt) == 0:
        return {"accuracy": float("inf"), "completeness": float("inf"),
                "overall": float("inf"), "n_pred": len(pred), "n_gt": len(gt)}
    d_acc = _nn_dist(pred, gt, max_dist)
    d_comp = _nn_dist(gt, pred, max_dist)
    acc = float(d_acc[d_acc < max_dist].mean()) if (d_acc < max_dist).any() else float("inf")
    comp = float(d_comp[d_comp < max_dist].mean()) if (d_comp < max_dist).any() else float("inf")
    return {
        "accuracy": acc,
        "completeness": comp,
        "overall": 0.5 * (acc + comp),
        "n_pred": int(len(pred)),
        "n_gt": int(len(gt)),
    }
