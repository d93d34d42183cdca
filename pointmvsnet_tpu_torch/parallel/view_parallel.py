"""View-parallel plane sweep: counterpart of
``pointmvsnet_tpu/parallel/view_parallel.py``.

The variance cost ``E_v[f²] − E_v[f]²`` decomposes into per-view moment
sums, so each rank of a view group warps only its slice of the V views and
one all-reduce of (Σf, Σf²) over the group combines them; the warped
per-view volumes never leave their rank. Every rank holds the features of
all V views (the image pyramid runs on each) and returns the whole cost
volume.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pointmvsnet_tpu_torch.ops.geometry import (
    cam_extrinsics,
    cam_intrinsics,
    pixel_grid,
    unproject_pixels,
)
from pointmvsnet_tpu_torch.ops.sampling import fetch_features
from pointmvsnet_tpu_torch.parallel import distributed


def view_sharded_plane_sweep(feats: torch.Tensor, cams: torch.Tensor, ref_cam: torch.Tensor,
                             depths: torch.Tensor, group) -> torch.Tensor:
    """Variance plane sweep with the V views shared out over ``group``.

    feats (B, V, h, w, C) and cams (B, V, 2, 4, 4) of every view at feature
    resolution; ref_cam (B, 2, 4, 4) the reference view's camera; depths
    (B, D). Rank r of the n ranks warps views [r·V/n, (r+1)·V/n), the
    reference view among them, with the projective fetch, and sums Σf and
    Σf² over them in f32. → cost (B, D, h, w, C) float32, the same on every
    rank of the group."""
    b, v, h, w, c = feats.shape
    d = depths.shape[-1]
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if v % n:
        raise ValueError(f"PARALLEL.VIEW={n} must divide the view count {v}")
    mine = slice(r * (v // n), (r + 1) * (v // n))
    ref32 = ref_cam.float()
    grid = pixel_grid(h, w, device=feats.device)
    pts = unproject_pixels(grid[None, None], depths.float()[..., None],
                           cam_extrinsics(ref32)[:, None], cam_intrinsics(ref32)[:, None])
    sampled = fetch_features(feats[:, mine], pts.reshape(b, d * h * w, 3), cams[:, mine])
    moments = distributed.all_reduce_sum(
        torch.stack([sampled.sum(dim=1), sampled.square().sum(dim=1)]), group)
    mean = moments[0] / v
    return (moments[1] / v - mean.square()).reshape(b, d, h, w, c)
