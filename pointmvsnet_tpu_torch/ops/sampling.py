"""Bilinear feature sampling: the eval-path subset of
``pointmvsnet_tpu/ops/sampling.py``.

Semantics are those of ``grid_sample(align_corners=True,
padding_mode="zeros")`` on raw pixel coordinates: each of the four taps
outside the image contributes zero on its own, and samples where ``valid``
(camera z > 0) is False are zero. The JAX package serves the four taps
from a 2×2 patch table because TPU row gathers are latency-bound; here
they are four ``index_select``s on the flattened map. Results are f32.

PointFlow's fetch, ``point_fetch`` (the source views' per-level samples
of every hypothesis point, reduced with the reference view's samples to
the variance over the views), takes a hand-written CUDA kernel,
``point_fetch_cuda`` (``csrc/point_fetch.cu``), where
``fetch_kernel_applies`` holds: bit-equal on the card to the composition
``point_fetch_plain``, which it takes elsewhere (the CPU, training under
autograd). Both write the levels' dtype.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from pointmvsnet_tpu_torch.ops import _cuda
from pointmvsnet_tpu_torch.ops.geometry import (
    cam_extrinsics,
    cam_intrinsics,
    project_points,
)

# launches of the fused fetch kernel (only ``point_fetch_cuda`` increments it)
launches = 0


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


def _perlevel_moments(levels: List[torch.Tensor], uv: torch.Tensor,
                      z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fetch_features_perlevel`` from the projection: uv (B, V, N, 2), z
    (B, V, N) at level-0 resolution."""
    valid = z > 0
    s1 = s2 = None
    for vi in range(levels[0].shape[1]):
        f_v = torch.cat([bilinear_sample(f[:, vi], uv[:, vi] * (1.0 / (1 << l)),
                                         valid=valid[:, vi])
                         for l, f in enumerate(levels)], dim=-1)
        s1 = f_v if s1 is None else s1 + f_v
        s2 = f_v.square() if s2 is None else s2 + f_v.square()
    return s1, s2


def fetch_features_perlevel(levels: List[torch.Tensor], points: torch.Tensor,
                            cams: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-level bilinear fetch over a stride-2 pyramid, reduced over views
    to the f32 moments (Σ_v f, Σ_v f²), each (B, N, ΣC_l).

    levels: [(B, V, h_l, w_l, C_l)] with h_l = h_0 / 2^l; cams at level-0
    resolution; points (B, N, 3)."""
    return _perlevel_moments(levels, *_project(points, cams))


def view_variance(ref_samples: Sequence[torch.Tensor], hyp_depth: torch.Tensor,
                  s1: torch.Tensor, s2: torch.Tensor, nv: int) -> torch.Tensor:
    """The variance over ``nv`` views of each hypothesis point's features,
    (B, G·n, ΣC_l) f32: the reference view's samples ``ref_samples``
    [(B, n, C_l)] broadcast over the G hypotheses of ``hyp_depth`` (B, G, n)
    and zero where the depth is not positive, with the source views'
    moments s1, s2 (B, G·n, ΣC_l) of ``fetch_features_perlevel``."""
    b, g, n = hyp_depth.shape
    ref_valid = (hyp_depth > 0)[..., None]
    ref_all = torch.cat([torch.where(ref_valid, r[:, None], 0.0).reshape(b, g * n, -1)
                         for r in ref_samples], dim=-1)
    mean = (ref_all + s1) / nv
    sq_mean = (ref_all.square() + s2) / nv
    return sq_mean - mean.square()


def fetch_kernel_applies(*tensors: torch.Tensor) -> bool:
    """Whether PointFlow's fetch over ``tensors`` (its inputs) takes
    ``point_fetch_cuda``: every one a CUDA tensor and no gradient needed
    (autograd off, or none requires one). The CPU and training under
    autograd take ``point_fetch_plain``, which autograd differentiates."""
    return (all(t.is_cuda for t in tensors)
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)))


def point_fetch_plain(levels: Sequence[torch.Tensor], uv: torch.Tensor, z: torch.Tensor,
                      ref_samples: Sequence[torch.Tensor], hyp_depth: torch.Tensor
                      ) -> torch.Tensor:
    """Plain version of ``point_fetch_cuda``, the composition: levels
    [(B, V, h_l, w_l, C_l)] of all V views (view 0 the reference), the
    source views' projection uv (B, V−1, G·n, 2) and z (B, V−1, G·n) at
    level-0 resolution, ``ref_samples`` and ``hyp_depth`` as
    ``view_variance`` takes them → (B, G·n, ΣC_l) in the levels' dtype."""
    s1, s2 = _perlevel_moments([f[:, 1:] for f in levels], uv, z)
    return view_variance(ref_samples, hyp_depth, s1, s2,
                         levels[0].shape[1]).to(levels[0].dtype)


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_MAX_LEVELS = 4


def check_fetch_args(levels: Sequence[torch.Tensor], uv: torch.Tensor, z: torch.Tensor,
                     ref_samples: Sequence[torch.Tensor], hyp_depth: torch.Tensor) -> int:
    """``point_fetch_cuda``'s checks of its arguments, on any device and
    without a launch → the channels each thread handles: the widest of 8,
    4, 2, 1 that divides every level's width and to whose vector every
    level and reference pointer is aligned."""
    if not 1 <= len(levels) <= _MAX_LEVELS or len(ref_samples) != len(levels):
        raise ValueError(f"want 1 to {_MAX_LEVELS} levels and a reference sample for each, "
                         f"got {len(levels)} and {len(ref_samples)}")
    lv_dtype = levels[0].dtype
    if lv_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"levels must be float32 or bfloat16, got {lv_dtype}")
    if levels[0].dim() != 5:
        raise ValueError(f"levels must be (B, V, h, w, C), got {tuple(levels[0].shape)}")
    b, v = levels[0].shape[:2]
    if hyp_depth.dim() != 3 or hyp_depth.shape[0] != b:
        raise ValueError(f"hyp_depth must be (B={b}, G, n), got {tuple(hyp_depth.shape)}")
    g, n = hyp_depth.shape[1:]
    if v < 2 or not 1 <= b <= 65535:
        raise ValueError(f"want V ≥ 2 views and 1 ≤ B ≤ 65535, got V={v}, B={b}")
    f32 = [("uv", uv, (b, v - 1, g * n, 2)), ("z", z, (b, v - 1, g * n)),
           ("hyp_depth", hyp_depth, (b, g, n))]
    for i, (f, r) in enumerate(zip(levels, ref_samples)):
        if f.dtype != lv_dtype or f.dim() != 5 or f.shape[:2] != (b, v) or f.shape[4] < 1:
            raise ValueError(f"level {i} {tuple(f.shape)} {f.dtype}: want (B={b}, V={v}, h, w, "
                             f"C ≥ 1) {lv_dtype}")
        if not f.is_contiguous():
            raise ValueError(f"level {i} must be contiguous")
        if f[0, 0].numel() >= 2 ** 31:
            raise ValueError(f"level {i}: a view's {f[0, 0].numel()} elements are past the "
                             f"kernel's 2^31")
        f32.append((f"ref_samples[{i}]", r, (b, n, f.shape[4])))
    for name, t, shape in f32:
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if uv.data_ptr() % 8:
        raise ValueError("uv must be aligned to 8 bytes")
    ch = next(c for c in (8, 4, 2, 1)
              if all(f.shape[4] % c == 0 and f.data_ptr() % (c * f.element_size()) == 0
                     and r.data_ptr() % (c * 4) == 0 for f, r in zip(levels, ref_samples)))
    if g * n * sum(f.shape[4] for f in levels) // ch >= 2 ** 31:
        raise ValueError(f"G·n·ΣC / {ch} = {g * n * sum(f.shape[4] for f in levels) // ch} "
                         f"threads: past the kernel's 2^31 per batch item")
    return ch


def point_fetch_cuda(levels: Sequence[torch.Tensor], uv: torch.Tensor, z: torch.Tensor,
                     ref_samples: Sequence[torch.Tensor], hyp_depth: torch.Tensor
                     ) -> torch.Tensor:
    """The CUDA kernel: same contract as ``point_fetch_plain`` and, on the
    card, the same bits, for every argument ``check_fetch_args`` takes."""
    global launches
    tensors = [*levels, uv, z, *ref_samples, hyp_depth]
    if not all(t.is_cuda and t.device == uv.device for t in tensors):
        raise ValueError("point_fetch_cuda takes CUDA tensors on one device")
    ch = check_fetch_args(levels, uv, z, ref_samples, hyp_depth)
    b, v = levels[0].shape[:2]
    g, n = hyp_depth.shape[1:]
    out = torch.empty(b, g * n, sum(f.shape[4] for f in levels), dtype=levels[0].dtype,
                      device=uv.device)
    nl = len(levels)
    lv_ptrs = (ctypes.c_void_p * nl)(*[f.data_ptr() for f in levels])
    ref_ptrs = (ctypes.c_void_p * nl)(*[r.data_ptr() for r in ref_samples])
    dims = (ctypes.c_int * (3 * nl))(*[d for f in levels for d in f.shape[2:]])
    lib = _cuda.load("point_fetch")
    err = lib.point_fetch(uv.data_ptr(), z.data_ptr(), hyp_depth.data_ptr(),
                          ctypes.addressof(lv_ptrs), ctypes.addressof(ref_ptrs),
                          ctypes.addressof(dims), nl, out.data_ptr(), b, v, g, n, ch,
                          int(levels[0].dtype == torch.bfloat16), uv.device.index,
                          _cuda.stream_of(uv))
    _cuda.check(lib, err, "point_fetch")
    launches += 1
    return out


def point_fetch(levels: Sequence[torch.Tensor], points: torch.Tensor,
                src_cams: torch.Tensor, ref_samples: Sequence[torch.Tensor],
                hyp_depth: torch.Tensor) -> torch.Tensor:
    """PointFlow's fetch: ``points`` (B, G·n, 3) projected into the source
    views ``src_cams`` (B, V−1, 2, 4, 4) at level-0 resolution, sampled in
    the source views of ``levels`` [(B, V, h_l, w_l, C_l)] and reduced with
    the reference view's ``ref_samples`` [(B, n, C_l)] to the variance over
    the V views (``view_variance``) → (B, G·n, ΣC_l) in the levels' dtype.
    Through ``point_fetch_cuda`` where ``fetch_kernel_applies``; else
    ``point_fetch_plain``, which autograd differentiates."""
    uv, z = _project(points, src_cams)
    if fetch_kernel_applies(points, src_cams, *levels):
        return point_fetch_cuda([f.contiguous() for f in levels], uv.contiguous(),
                                z.contiguous(), [r.contiguous() for r in ref_samples],
                                hyp_depth.contiguous())
    return point_fetch_plain(levels, uv, z, ref_samples, hyp_depth)
