"""Masked window max for EdgeConv's eval fast path: counterpart of
``pointmvsnet_tpu/ops/pallas/edge.py`` (``masked_window_max`` and its XLA
twin ``masked_window_max_xla``).

out[b, p, f] = max of z[b, nbr_s(p), f] over the window candidates s set
in p's kNN selection mask. ``masked_window_max`` dispatches on the
device: CUDA tensors go to the hand-written kernel
``csrc/masked_window_max.cu``, CPU tensors to ``masked_window_max_plain``.
Both fold with ``jnp.maximum``'s semantics: a NaN wins, +0 wins over −0,
and equal values are bit-identical otherwise. The result then does not
depend on the order the candidates are visited in, and the two agree bit
for bit (NaN payloads aside) with each other and with the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from pointmvsnet_tpu_torch.ops import _cuda

# launches of the CUDA kernel (only ``masked_window_max_cuda`` increments it)
launches = 0

_NEG = torch.finfo(torch.float32).min / 2   # value where no candidate is set
_INT_OF_SIZE = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def maximum_ieee(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum``: NaN if either is NaN, +0 for (−0, +0) in either
    order. ``torch.maximum`` returns its first argument for two zeros, so
    the sign bit is cleared wherever the signs differ: that changes only
    the (−0, +0) case, since otherwise the larger value is the one that is
    not negative."""
    it = _INT_OF_SIZE[a.element_size()]
    m = torch.maximum(a, b).view(it)
    sign = torch.iinfo(it).min
    return (m & ~((a.view(it) ^ b.view(it)) & sign)).view(a.dtype)


def masked_window_max_plain(z: torch.Tensor, mask: torch.Tensor,
                            grid_shape: Tuple[int, int, int],
                            window: int = 5) -> torch.Tensor:
    """Plain version. z (B, G·H·W, F) g-major; mask (B, NW, G, H, W) int32
    bitplanes from ``ops.knn.window_knn_mask`` → (B, G·H·W, F) in z's dtype.
    Set bits that point outside the image, or at a level ≥ G, add nothing;
    the result is never below −finfo(f32).max / 2 (rounded to z's dtype),
    its value where no bit is set."""
    g, h, w = grid_shape
    b, p, f = z.shape
    r = window // 2
    zg = z.reshape(b, g, h, w, f)
    padded = F.pad(zg, (0, 0, r, r, r, r), value=_NEG)
    acc = torch.full((b, g, h, w, f), _NEG, dtype=z.dtype, device=z.device)
    for gc in range(g):
        for dy in range(window):
            for dx in range(window):
                s = (gc * window + dy) * window + dx
                sel = ((mask[:, s // 32] >> (s % 32)) & 1).bool()[..., None]
                cand = padded[:, gc, dy:dy + h, dx:dx + w][:, None]   # (B,1,H,W,F)
                acc = torch.where(sel, maximum_ieee(acc, cand), acc)
    return acc.reshape(b, p, f)


def masked_window_max_cuda(z: torch.Tensor, mask: torch.Tensor,
                           grid_shape: Tuple[int, int, int],
                           window: int = 5) -> torch.Tensor:
    """The CUDA kernel: same contract as ``masked_window_max_plain`` for
    window = 5, z float32 or bfloat16 with F ≤ 128. Raises on anything it
    does not take."""
    global launches
    g, h, w = grid_shape
    if not (z.is_cuda and mask.is_cuda):
        raise ValueError("masked_window_max_cuda takes CUDA tensors")
    if z.dtype not in (torch.float32, torch.bfloat16) or not z.is_contiguous():
        raise ValueError("z must be contiguous float32 or bfloat16")
    if z.dim() != 3 or z.shape[1] != g * h * w or z.shape[2] > 128:
        raise ValueError(f"z {tuple(z.shape)} does not match grid {grid_shape} (F ≤ 128)")
    nw = -(-(g * window * window) // 32)
    if (mask.dtype != torch.int32 or not mask.is_contiguous()
            or mask.shape != (z.shape[0], nw, g, h, w)):
        raise ValueError(f"mask must be contiguous int32 {(z.shape[0], nw, g, h, w)}")
    if window != 5 or g * window * window > 128:
        raise ValueError("the kernel is built for window=5 and at most 128 candidates")
    out = torch.empty_like(z)
    lib = _cuda.load("masked_window_max")
    err = lib.masked_window_max(z.data_ptr(), mask.data_ptr(), out.data_ptr(),
                                z.shape[0], g, h, w, z.shape[2],
                                int(z.dtype == torch.bfloat16), z.device.index,
                                _cuda.stream_of(z))
    _cuda.check(lib, err, "masked_window_max")
    launches += 1
    return out


def masked_window_max(z: torch.Tensor, mask: torch.Tensor,
                      grid_shape: Tuple[int, int, int],
                      window: int = 5) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if z.is_cuda:
        return masked_window_max_cuda(z, mask, grid_shape, window)
    if z.device.type == "cpu":
        return masked_window_max_plain(z, mask, grid_shape, window)
    raise ValueError(f"unsupported device {z.device}")
