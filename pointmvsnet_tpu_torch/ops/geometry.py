"""Camera geometry: pixel grids, project/unproject, depth hypotheses.

Counterpart of ``pointmvsnet_tpu/ops/geometry.py``, with its conventions:
pixel centers at integer coordinates (``align_corners=True``); camera
layout ``(2, 4, 4)`` with ``cam[0]`` the world→camera extrinsic,
``cam[1, :3, :3]`` = K and ``cam[1, 3] = [d_min, d_interval, d_num,
d_max]``. Geometry always runs in float32: bf16 pixel coordinates
quantize to whole pixels at 640-wide maps.
"""

from __future__ import annotations

from typing import Tuple

import torch


def cam_extrinsics(cams: torch.Tensor) -> torch.Tensor:
    """(..., 2, 4, 4) → world→camera (..., 4, 4)."""
    return cams[..., 0, :, :]


def cam_intrinsics(cams: torch.Tensor) -> torch.Tensor:
    """(..., 2, 4, 4) → K (..., 3, 3)."""
    return cams[..., 1, :3, :3]


def cam_depth_range(cams: torch.Tensor):
    """(..., 2, 4, 4) → (depth_min, depth_interval, num_depth, depth_max)."""
    row = cams[..., 1, 3, :]
    return row[..., 0], row[..., 1], row[..., 2], row[..., 3]


def pixel_grid(height: int, width: int, device=None) -> torch.Tensor:
    """Homogeneous pixel coordinates (H·W, 3), rows ``[u, v, 1]``, v-major."""
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=device),
                          torch.arange(width, dtype=torch.float32, device=device),
                          indexing="ij")
    return torch.stack([u, v, torch.ones_like(u)], dim=-1).reshape(height * width, 3)


def depth_hypotheses(depth_min: torch.Tensor, depth_interval: torch.Tensor,
                     num_depth: int) -> torch.Tensor:
    """Fronto-parallel plane depths ``d_j = d_min + j·interval`` → (..., D)."""
    j = torch.arange(num_depth, dtype=torch.float32, device=depth_min.device)
    return depth_min[..., None] + j * depth_interval[..., None]


def intrinsic_inverse(intrinsic: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of a pinhole K = [[fx, s, cx], [0, fy, cy], [0, 0, 1]]
    (a generic LU inverse adds ~1e-4 of noise that breaks depth parity)."""
    fx = intrinsic[..., 0, 0]
    s = intrinsic[..., 0, 1]
    cx = intrinsic[..., 0, 2]
    fy = intrinsic[..., 1, 1]
    cy = intrinsic[..., 1, 2]
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    inv_fx = 1.0 / fx
    inv_fy = 1.0 / fy
    row0 = torch.stack([inv_fx, -s * inv_fx * inv_fy,
                        (s * cy - cx * fy) * inv_fx * inv_fy], dim=-1)
    row1 = torch.stack([zero, inv_fy, -cy * inv_fy], dim=-1)
    row2 = torch.stack([zero, zero, one], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def unproject_pixels(pixels_h: torch.Tensor, depth: torch.Tensor,
                     extrinsic: torch.Tensor, intrinsic: torch.Tensor) -> torch.Tensor:
    """pixels_h (..., N, 3) rows [u, v, 1], depth (..., N) camera z,
    extrinsic (..., 4, 4), intrinsic (..., 3, 3) → world points (..., N, 3)."""
    k_inv = intrinsic_inverse(intrinsic)
    cam_pts = torch.einsum("...ij,...nj->...ni", k_inv, pixels_h) * depth[..., None]
    r = extrinsic[..., :3, :3]
    t = extrinsic[..., :3, 3]
    # world = Rᵀ (X_c − t)
    return torch.einsum("...ji,...nj->...ni", r, cam_pts - t[..., None, :])


def project_points(points: torch.Tensor, extrinsic: torch.Tensor,
                   intrinsic: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points (..., N, 3) → (pixel uv (..., N, 2), camera z (..., N)).
    ``uv`` stays finite behind the camera (|z| clamped in the divide); mask
    with ``z``."""
    r = extrinsic[..., :3, :3]
    t = extrinsic[..., :3, 3]
    cam_pts = torch.einsum("...ij,...nj->...ni", r, points) + t[..., None, :]
    proj = torch.einsum("...ij,...nj->...ni", intrinsic, cam_pts)
    z = proj[..., 2]
    safe_z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    return proj[..., :2] / safe_z[..., None], z
