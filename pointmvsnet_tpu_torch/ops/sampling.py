"""Bilinear feature sampling: the eval-path subset of
``pointmvsnet_tpu/ops/sampling.py``.

Semantics are those of ``grid_sample(align_corners=True,
padding_mode="zeros")`` on raw pixel coordinates: each of the four taps
outside the image contributes zero on its own, and samples where ``valid``
(camera z > 0) is False are zero. The JAX package serves the four taps
from a 2×2 patch table because TPU row gathers are latency-bound; here
they are four ``index_select``s on the flattened map. Results are f32.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from pointmvsnet_tpu_torch.ops.geometry import (
    cam_extrinsics,
    cam_intrinsics,
    project_points,
)


def bilinear_sample(feat: torch.Tensor, uv: torch.Tensor,
                    valid: torch.Tensor | None = None) -> torch.Tensor:
    """Sample ``feat`` (..., H, W, C) at pixel coords ``uv`` (..., N, 2);
    leading dims must agree. → (..., N, C) float32."""
    lead = feat.shape[:-3]
    h, w, c = feat.shape[-3:]
    nb = 1
    for d in lead:
        nb *= d
    flat = feat.reshape(nb * h * w, c)
    u = uv[..., 0].reshape(nb, -1)
    v = uv[..., 1].reshape(nb, -1)
    n = u.shape[-1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]
    i0 = u0.long()
    j0 = v0.long()
    base = (torch.arange(nb, device=feat.device) * (h * w))[:, None]

    def tap(i, j):
        inside = ((i >= 0) & (i <= w - 1) & (j >= 0) & (j <= h - 1))[..., None]
        idx = base + j.clamp(0, h - 1) * w + i.clamp(0, w - 1)
        rows = flat.index_select(0, idx.reshape(-1)).reshape(nb, n, c)
        return torch.where(inside, rows, 0)

    out = (tap(i0, j0) * ((1 - du) * (1 - dv))
           + tap(i0 + 1, j0) * (du * (1 - dv))
           + tap(i0, j0 + 1) * ((1 - du) * dv)
           + tap(i0 + 1, j0 + 1) * (du * dv))
    if valid is not None:
        out = torch.where(valid.reshape(nb, n, 1), out, 0)
    return out.reshape(*lead, n, c)


def regular_grid_sample(feat: torch.Tensor, sx: float, sy: float,
                        out_h: int, out_w: int, y_offset: int = 0) -> torch.Tensor:
    """Bilinear-sample ``feat`` (B, H, W, C) at the regular grid u = j·sx,
    v = (y_offset + i)·sy (the reference view's fetch, where every
    hypothesis depth projects back onto the scaled pixel grid; a row band
    of the flow map starts at row ``y_offset``), as two interpolation
    matmuls. → (B, out_h·out_w, C) float32."""
    b, h, w, c = feat.shape

    def interp_matrix(n_out, scale, n_in, offset=0):
        t = (torch.arange(n_out, dtype=torch.float32, device=feat.device) + offset) * scale
        t0 = torch.floor(t)
        dt = (t - t0)[:, None]
        i0 = t0.long()[:, None]
        cols = torch.arange(n_in, device=feat.device)[None, :]
        return (torch.where((cols == i0) & (i0 >= 0) & (i0 <= n_in - 1), 1.0 - dt, 0.0)
                + torch.where((cols == i0 + 1) & (i0 + 1 >= 0) & (i0 + 1 <= n_in - 1),
                              dt, 0.0))                      # (n_out, n_in)

    mx = interp_matrix(out_w, sx, w)
    my = interp_matrix(out_h, sy, h, y_offset)
    y = torch.einsum("bhwc,ow->bhoc", feat.float(), mx)
    y = torch.einsum("bhoc,ph->bpoc", y, my)
    return y.reshape(b, out_h * out_w, c)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, H, W) → (B, out_h, out_w), bilinear with half-pixel centres and
    edges clamped: ``F.interpolate(mode="bilinear", align_corners=False)``
    and, for upsampling, ``jax.image.resize(method="bilinear")``. Computed
    as two interpolation matmuls, as the JAX package's resize is, so that
    its backward is deterministic on the card (``F.interpolate``'s CUDA
    backward accumulates with atomics)."""
    b, h, w = x.shape

    def lerp_matrix(n_out, n_in):
        t = ((torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5)
             * (n_in / n_out) - 0.5).clamp_min(0.0)
        i0 = t.long()
        lam = (t - i0)[:, None]
        i1 = (i0 + 1).clamp_max(n_in - 1)[:, None]
        cols = torch.arange(n_in, device=x.device)[None, :]
        return (torch.where(cols == i0[:, None], 1.0 - lam, 0.0)
                + torch.where(cols == i1, lam, 0.0))            # (n_out, n_in)

    y = torch.einsum("bhw,ow->bho", x.float(), lerp_matrix(out_w, w))
    return torch.einsum("bho,ph->bpo", y, lerp_matrix(out_h, h))


def _project(points: torch.Tensor, cams: torch.Tensor):
    """points (B, N, 3), cams (B, V, 2, 4, 4) → uv (B, V, N, 2), z (B, V, N),
    in f32 whatever the inputs' dtype."""
    cams32 = cams.float()
    return project_points(points.float()[:, None], cam_extrinsics(cams32),
                          cam_intrinsics(cams32))


def fetch_features(feats: torch.Tensor, points: torch.Tensor,
                   cams: torch.Tensor) -> torch.Tensor:
    """feats (B, V, H, W, C), points (B, N, 3) world, cams (B, V, 2, 4, 4)
    → (B, V, N, C) f32; points behind a camera or outside its image give 0."""
    uv, z = _project(points, cams)
    return bilinear_sample(feats, uv, valid=z > 0)


def fetch_features_perlevel(levels: List[torch.Tensor], points: torch.Tensor,
                            cams: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-level bilinear fetch over a stride-2 pyramid, reduced over views
    to the f32 moments (Σ_v f, Σ_v f²), each (B, N, ΣC_l).

    levels: [(B, V, h_l, w_l, C_l)] with h_l = h_0 / 2^l; cams at level-0
    resolution; points (B, N, 3)."""
    uv, z = _project(points, cams)
    valid = z > 0
    s1 = s2 = None
    for vi in range(levels[0].shape[1]):
        f_v = torch.cat([bilinear_sample(f[:, vi], uv[:, vi] * (1.0 / (1 << l)),
                                         valid=valid[:, vi])
                         for l, f in enumerate(levels)], dim=-1)
        s1 = f_v if s1 is None else s1 + f_v
        s2 = f_v.square() if s2 is None else s2 + f_v.square()
    return s1, s2
