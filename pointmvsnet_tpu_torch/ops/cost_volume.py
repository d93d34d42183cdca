"""Plane-sweep cost volume, soft-argmin depth regression, confidence:
counterpart of ``pointmvsnet_tpu/ops/cost_volume.py``. The warp is a plain
bilinear gather (the JAX package's MXU slab gather is a TPU workaround).

Depth hypotheses are fronto-parallel planes (B, D), one depth per plane
(Point-MVSNet's coarse stage), or per pixel (B, D, h, w) (the cascade's
later stages, CasMVSNet); the planes path is the per-pixel one with the
depths broadcast over the pixels, bit for bit."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pointmvsnet_tpu_torch.ops.geometry import (
    cam_extrinsics,
    cam_intrinsics,
    pixel_grid,
    unproject_pixels,
)
from pointmvsnet_tpu_torch.ops.sampling import fetch_features


def plane_sweep_volume(feats: torch.Tensor, cams: torch.Tensor,
                       depths: torch.Tensor) -> torch.Tensor:
    """Variance-aggregated plane-sweep cost volume.

    feats (B, V, h, w, C) with view 0 the reference; cams (B, V, 2, 4, 4)
    at feature resolution; depths (B, D) planes or (B, D, h, w) per pixel
    → cost (B, D, h, w, C) float32."""
    b, v, h, w, c = feats.shape
    d = depths.shape[1]
    cams = cams.float()
    grid = pixel_grid(h, w, device=feats.device)
    # (B, D, 1) broadcast over the pixels, or (B, D, h·w)
    per_pt = (depths.float()[..., None] if depths.dim() == 2
              else depths.float().reshape(b, d, h * w))
    pts = unproject_pixels(grid[None, None], per_pt,
                           cam_extrinsics(cams)[:, 0, None],
                           cam_intrinsics(cams)[:, 0, None])   # (B, D, h·w, 3)
    pts = pts.reshape(b, d * h * w, 3)

    # the reference view projects every hypothesis back onto its own pixel
    # grid: it contributes its feature map directly, masked where the
    # depth is non-positive (the z > 0 gate of the projective path)
    ref_f = feats[:, 0].float().reshape(b, 1, h * w, c)
    ref_f = torch.where((per_pt > 0)[..., None], ref_f, 0.0)
    ref_f = ref_f.reshape(b, d * h * w, c)
    src = fetch_features(feats[:, 1:], pts, cams[:, 1:])     # (B, V−1, D·h·w, C)
    mean = (ref_f + src.sum(dim=1)) / v
    sq_mean = (ref_f.square() + src.square().sum(dim=1)) / v
    return (sq_mean - mean.square()).reshape(b, d, h, w, c)


def depth_regression(prob_volume: torch.Tensor, depths: torch.Tensor) -> torch.Tensor:
    """prob_volume (B, D, h, w) softmax over D, depths (B, D) planes or
    (B, D, h, w) per pixel → (B, h, w)."""
    if depths.dim() == 2:
        return torch.einsum("bdhw,bd->bhw", prob_volume, depths)
    return (prob_volume * depths).sum(dim=1)


def photometric_confidence(prob_volume: torch.Tensor) -> torch.Tensor:
    """Probability mass of the 4 hypotheses around the argmax (MVSNet §3.3):
    (B, D, h, w) → (B, h, w) in [0, 1]."""
    pad = F.pad(prob_volume, (0, 0, 0, 0, 1, 2))
    csum = F.pad(torch.cumsum(pad, dim=1), (0, 0, 0, 0, 1, 0))
    # window sum at j = Σ prob[j−1 : j+3] = csum[j+4] − csum[j]
    win4 = csum[:, 4:] - csum[:, :-4]
    idx = prob_volume.argmax(dim=1, keepdim=True)
    return torch.gather(win4, 1, idx)[:, 0]


def regressed_confidence(prob_volume: torch.Tensor) -> torch.Tensor:
    """Probability mass of the 4 hypotheses around the regressed index
    ⌊Σ_d p_d·d⌋, clamped to [0, D−1] (CasMVSNet's photometric confidence:
    4·avgpool₄ of the volume padded by 1 and 2 along D, taken there):
    (B, D, h, w) → (B, h, w) in [0, 1]."""
    b, d = prob_volume.shape[:2]
    pad = F.pad(prob_volume, (0, 0, 0, 0, 1, 2))
    win4 = pad[:, 0:d] + pad[:, 1:d + 1] + pad[:, 2:d + 2] + pad[:, 3:d + 3]
    k = torch.arange(d, dtype=prob_volume.dtype, device=prob_volume.device).expand(b, d)
    idx = depth_regression(prob_volume, k).long().clamp(0, d - 1)
    return torch.gather(win4, 1, idx[:, None])[:, 0]
