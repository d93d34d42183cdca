"""Plane-sweep cost volume, soft-argmin depth regression, confidence:
counterpart of ``pointmvsnet_tpu/ops/cost_volume.py``. The warp is a plain
bilinear gather (the JAX package's MXU slab gather is a TPU workaround).

Depth hypotheses are fronto-parallel planes (B, D), one depth per plane
(Point-MVSNet's coarse stage), or per pixel (B, D, h, w) (the cascade's
later stages, CasMVSNet); the planes path is the per-pixel one with the
depths broadcast over the pixels, bit for bit.

The variance over the views takes a hand-written CUDA kernel,
``plane_sweep_cuda`` (``csrc/plane_sweep.cu``), where
``fetch_kernel_applies`` holds (CUDA inputs, no gradient needed): bit-equal
on the card to the composition ``plane_sweep_plain``, which it takes
elsewhere (the CPU, training under autograd). Both write the features'
dtype."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pointmvsnet_tpu_torch.ops import _cuda
from pointmvsnet_tpu_torch.ops.geometry import (
    cam_extrinsics,
    cam_intrinsics,
    pixel_grid,
    unproject_pixels,
)
from pointmvsnet_tpu_torch.ops.sampling import _project, bilinear_sample, fetch_kernel_applies

# launches of the sweep kernel (only ``plane_sweep_cuda`` increments it)
launches = 0


def _depth_per_point(depths: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, D) planes → (B, D, 1), broadcast over the pixels; (B, D, h, w) →
    (B, D, h·w); f32."""
    b, d = depths.shape[:2]
    return (depths.float()[..., None] if depths.dim() == 2
            else depths.float().reshape(b, d, h * w))


def plane_sweep_volume(feats: torch.Tensor, cams: torch.Tensor,
                       depths: torch.Tensor) -> torch.Tensor:
    """Variance-aggregated plane-sweep cost volume.

    feats (B, V, h, w, C) with view 0 the reference; cams (B, V, 2, 4, 4)
    at feature resolution; depths (B, D) planes or (B, D, h, w) per pixel
    → cost (B, D, h, w, C) in the features' dtype: through
    ``plane_sweep_cuda`` where ``fetch_kernel_applies``; else
    ``plane_sweep_plain``, which autograd differentiates."""
    b, v, h, w, c = feats.shape
    d = depths.shape[1]
    cams = cams.float()
    grid = pixel_grid(h, w, device=feats.device)
    pts = unproject_pixels(grid[None, None], _depth_per_point(depths, h, w),
                           cam_extrinsics(cams)[:, 0, None],
                           cam_intrinsics(cams)[:, 0, None])   # (B, D, h·w, 3)
    uv, z = _project(pts.reshape(b, d * h * w, 3), cams[:, 1:])
    if fetch_kernel_applies(feats, cams, depths):
        return plane_sweep_cuda(feats.contiguous(), uv.contiguous(), z.contiguous(),
                                depths.float().contiguous())
    return plane_sweep_plain(feats, uv, z, depths)


def _reference(feats: torch.Tensor, depths: torch.Tensor) -> torch.Tensor:
    """The reference view's samples of every hypothesis, (B, D·h·w, C) f32:
    it projects every hypothesis back onto its own pixel grid, so it
    contributes its feature map directly, masked where the depth is
    non-positive (the z > 0 gate of the projective path)."""
    b, v, h, w, c = feats.shape
    ref_f = feats[:, 0].float().reshape(b, 1, h * w, c)
    ref_f = torch.where((_depth_per_point(depths, h, w) > 0)[..., None], ref_f, 0.0)
    return ref_f.reshape(b, -1, c)


def _variance(ref_f: torch.Tensor, src: torch.Tensor, shape) -> torch.Tensor:
    """The variance over the V views of ``feats.shape`` ``shape`` from the
    reference samples ``ref_f`` and the source views' samples ``src``
    (B, V−1, D·h·w, C), f32 → (B, D, h, w, C) f32."""
    b, v, h, w, c = shape
    mean = (ref_f + src.sum(dim=1)) / v
    sq_mean = (ref_f.square() + src.square().sum(dim=1)) / v
    return (sq_mean - mean.square()).reshape(b, -1, h, w, c)


def plane_sweep_plain(feats: torch.Tensor, uv: torch.Tensor, z: torch.Tensor,
                      depths: torch.Tensor) -> torch.Tensor:
    """Plain version of ``plane_sweep_cuda``, the composition from the
    source views' projection, cast to the features' dtype: feats (B, V, h,
    w, C), uv (B, V−1, D·h·w, 2) and z (B, V−1, D·h·w) of every hypothesis,
    depths (B, D) or (B, D, h, w) → (B, D, h, w, C)."""
    ref_f = _reference(feats, depths)
    src = bilinear_sample(feats[:, 1:], uv, valid=z > 0)   # fetch_features after _project
    return _variance(ref_f, src, feats.shape).to(feats.dtype)


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def check_sweep_args(feats: torch.Tensor, uv: torch.Tensor, z: torch.Tensor,
                     depths: torch.Tensor) -> int:
    """``plane_sweep_cuda``'s checks of its arguments, on any device and
    without a launch → the channels each thread handles: the widest of 8,
    4, 2, 1 that divides C and to whose vector the features' pointer is
    aligned."""
    if feats.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"feats must be float32 or bfloat16, got {feats.dtype}")
    if feats.dim() != 5 or feats.shape[4] < 1:
        raise ValueError(f"feats must be (B, V, h, w, C ≥ 1), got {tuple(feats.shape)}")
    b, v, h, w, c = feats.shape
    if v < 2 or not 1 <= b <= 65535:
        raise ValueError(f"want V ≥ 2 views and 1 ≤ B ≤ 65535, got V={v}, B={b}")
    if not feats.is_contiguous():
        raise ValueError("feats must be contiguous")
    if h * w * c >= 2 ** 31:
        raise ValueError(f"a view's {h * w * c} elements are past the kernel's 2^31")
    if depths.dim() not in (2, 4) or depths.shape[0] != b or (
            depths.dim() == 4 and tuple(depths.shape[2:]) != (h, w)):
        raise ValueError(f"depths must be (B={b}, D) or (B={b}, D, h={h}, w={w}), got "
                         f"{tuple(depths.shape)}")
    d = depths.shape[1]
    for name, t, shape in [("uv", uv, (b, v - 1, d * h * w, 2)), ("z", z, (b, v - 1, d * h * w)),
                           ("depths", depths, tuple(depths.shape))]:
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if uv.data_ptr() % 8:
        raise ValueError("uv must be aligned to 8 bytes")
    ch = next(k for k in (8, 4, 2, 1)
              if c % k == 0 and feats.data_ptr() % (k * feats.element_size()) == 0)
    if d * h * w * c // ch >= 2 ** 31:
        raise ValueError(f"D·h·w·C / {ch} = {d * h * w * c // ch} threads: past the kernel's "
                         f"2^31 per batch item")
    return ch


def plane_sweep_cuda(feats: torch.Tensor, uv: torch.Tensor, z: torch.Tensor,
                     depths: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: same contract as ``plane_sweep_plain`` and, on the
    card, the same bits, for every argument ``check_sweep_args`` takes."""
    global launches
    if not all(t.is_cuda and t.device == feats.device for t in (feats, uv, z, depths)):
        raise ValueError("plane_sweep_cuda takes CUDA tensors on one device")
    ch = check_sweep_args(feats, uv, z, depths)
    b, v, h, w, c = feats.shape
    d = depths.shape[1]
    out = torch.empty(b, d, h, w, c, dtype=feats.dtype, device=feats.device)
    lib = _cuda.load("plane_sweep")
    err = lib.plane_sweep(uv.data_ptr(), z.data_ptr(), depths.data_ptr(), feats.data_ptr(),
                          out.data_ptr(), b, v, d, h, w, c, int(depths.dim() == 4), ch,
                          int(feats.dtype == torch.bfloat16), feats.device.index,
                          _cuda.stream_of(feats))
    _cuda.check(lib, err, "plane_sweep")
    launches += 1
    return out


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
