"""Depth-map fusion on the card: the port's twin of
``pointmvsnet_tpu/postprocess/fusion_jax.py``.

The protocol of ``fusion.fuse_depth_maps`` (probability filter →
cross-view geometric consistency → visibility-averaged depth →
unprojection), with the consistency sweep run for all reference views at
once over the stacked (V, H, W) scan: a loop over the columns of the
padded pair table (−1 padding) accumulates each reference pixel's
consistent-view count and depth sum. Nearest sampling rounds half to
even (``torch.round``), as numpy does. The 3×3 camera products are
written as broadcast multiply-adds, so no TF32 matmul setting can change
them. numpy's BLAS may round a 3×3 product differently in the last bit;
where a projected coordinate lies within that bit of a half pixel, the
two backends sample neighbouring pixels, so large noisy scans can differ
in a few points in 10^4 (small or smooth ones come out equal). All depth
maps of a scan must share one (H, W); mixed-resolution scans take the
numpy path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pointmvsnet_tpu_torch import resolve_device


def _mat(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Per-view 3×3 product: m (V, 3, 3), p (V, N, 3) → m·p (V, N, 3)."""
    return (m[:, None] * p[:, :, None, :]).sum(-1)


def _fuse_all(depths: torch.Tensor, cams: torch.Tensor, probs: Optional[torch.Tensor],
              pair_table: torch.Tensor, prob_threshold: float, pix_threshold: float,
              depth_threshold: float, min_views: int):
    """depths (V, H, W) f32, cams (V, 2, 4, 4), probs (V, H, W) or None,
    pair_table (V, S) int64 (−1 padding) → (keep (V, N) bool, points
    (V, N, 3) f32), N = H·W row-major."""
    v, h, w = depths.shape
    n = h * w
    dev = depths.device
    r, t, k = cams[:, 0, :3, :3], cams[:, 0, :3, 3], cams[:, 1, :3, :3]
    kinv = torch.linalg.inv(k)
    rt = r.transpose(1, 2)

    d_flat = depths.reshape(v, n)
    valid = d_flat > 0
    if probs is not None:
        valid &= probs.reshape(v, n) > prob_threshold
    ii, jj = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    uv_ref = torch.stack([jj.reshape(-1), ii.reshape(-1)], -1)[None]          # (1, N, 2)

    def unproject(uv, depth, kinv_v, rt_v, t_v):
        """pixels (V|1, N, 2) + depth (V, N) → world (V, N, 3)."""
        p = torch.cat([uv, torch.ones_like(uv[..., :1])], -1).expand(depth.shape[0], -1, -1)
        pc = _mat(kinv_v, p) * depth[..., None]
        return _mat(rt_v, pc - t_v[:, None])

    def project(pts, r_v, t_v, k_v):
        """world (V, N, 3) → uv (V, N, 2), z (V, N)."""
        uvw = _mat(k_v, _mat(r_v, pts) + t_v[:, None])
        z = uvw[..., 2]
        safe = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        return uvw[..., :2] / safe[..., None], z

    world = unproject(uv_ref, d_flat, kinv, rt, t)
    n_cons = torch.zeros((v, n), dtype=torch.int32, device=dev)
    depth_sum = d_flat.clone()
    for s in range(pair_table.shape[1]):
        src = pair_table[:, s]
        live = src >= 0
        sidx = src.clamp(min=0)
        uv_j, z_j = project(world, r[sidx], t[sidx], k[sidx])
        x = torch.round(uv_j[..., 0]).long()
        y = torch.round(uv_j[..., 1]).long()
        inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        lin = y.clamp(0, h - 1) * w + x.clamp(0, w - 1)
        dsamp = torch.gather(d_flat[sidx], 1, lin)
        ok = inside & (dsamp > 0) & (z_j > 0)
        world_j = unproject(uv_j, dsamp, kinv[sidx], rt[sidx], t[sidx])
        uv_back, z_back = project(world_j, r, t, k)                      # back into the ref
        pix_err = torch.linalg.vector_norm(uv_back - uv_ref, dim=-1)
        rel_d = (z_back - d_flat).abs() / d_flat.clamp(min=1e-9)
        cons = ok & (pix_err < pix_threshold) & (rel_d < depth_threshold) & live[:, None]
        n_cons += cons.int()
        depth_sum += torch.where(cons, z_back, torch.zeros_like(z_back))
    keep = valid & (n_cons >= min_views)
    fused = depth_sum / (n_cons + 1).float()
    return keep, unproject(uv_ref, fused, kinv, rt, t)


def fuse_depth_maps_torch(depths: Sequence[np.ndarray], cams: Sequence[np.ndarray],
                          probs: Optional[Sequence[np.ndarray]] = None,
                          images: Optional[Sequence[np.ndarray]] = None,
                          pairs: Optional[Dict[int, List[int]]] = None,
                          prob_threshold: float = 0.8, pix_threshold: float = 1.0,
                          depth_threshold: float = 0.01, min_views: int = 3,
                          device="cuda") -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Twin of ``fusion.fuse_depth_maps`` (same output order: reference
    view major, pixels row-major) with the consistency sweep on
    ``device`` (CUDA unless the caller asks for the CPU). All depth maps
    must share one (H, W)."""
    dev = resolve_device(device)
    nviews = len(depths)
    shapes = {np.asarray(d).shape for d in depths}
    if len(shapes) != 1:
        raise ValueError(f"torch fusion needs uniform shapes, got {shapes}")
    src_lists = [list(pairs[ref]) if pairs is not None else
                 [j for j in range(nviews) if j != ref] for ref in range(nviews)]
    table = np.full((nviews, max((len(s) for s in src_lists), default=0)), -1, np.int64)
    for i, s in enumerate(src_lists):
        table[i, :len(s)] = s

    def stack(arrs):
        return torch.from_numpy(np.stack([np.asarray(a, np.float32) for a in arrs])).to(dev)

    keep, points = _fuse_all(stack(depths), stack(cams),
                             stack(probs) if probs is not None else None,
                             torch.from_numpy(table).to(dev),
                             prob_threshold=float(prob_threshold),
                             pix_threshold=float(pix_threshold),
                             depth_threshold=float(depth_threshold),
                             min_views=int(min_views))
    keep, points = keep.cpu().numpy(), points.cpu().numpy()

    h, w = next(iter(shapes))
    all_pts, all_cols = [], []
    for ref in range(nviews):
        m = keep[ref]
        if not m.any():
            continue
        all_pts.append(points[ref][m])
        if images is not None:
            img = np.asarray(images[ref])
            if img.max() <= 1.0 + 1e-6:
                img = img * 255.0
            all_cols.append(img.reshape(h * w, -1)[m].astype(np.uint8))
    if not all_pts:
        return np.zeros((0, 3), np.float32), None
    return np.concatenate(all_pts, 0), np.concatenate(all_cols, 0) if all_cols else None
