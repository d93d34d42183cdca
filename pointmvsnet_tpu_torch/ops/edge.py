"""Masked window max for EdgeConv's eval fast path: counterpart of
``pointmvsnet_tpu/ops/pallas/edge.py`` (``masked_window_max`` and its XLA
twin ``masked_window_max_xla``).

out[b, p, f] = max of z[b, nbr_s(p), f] over the window candidates s set
in p's kNN selection mask. ``masked_window_max`` dispatches on the
device: CUDA tensors go to the hand-written kernel
``csrc/masked_window_max.cu``, CPU tensors to ``masked_window_max_plain``.
The kernel takes every window and level count the kNN produces and any F,
in f32 and bf16, with the tile and channel chunk ``staging_plan`` picks.
Both fold with ``jnp.maximum``'s semantics: a NaN wins, +0 wins over −0,
and equal values are bit-identical otherwise. The result then does not
depend on the order the candidates are visited in, and the two agree bit
for bit (NaN payloads aside) with each other and with the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from pointmvsnet_tpu_torch.ops import _cuda
from pointmvsnet_tpu_torch.ops.knn import check_window

# launches of the CUDA kernel (only ``masked_window_max_cuda`` increments it)
launches = 0

_NEG = torch.finfo(torch.float32).min / 2   # value where no candidate is set
_TABLE_BYTES = 512           # the kernel's static bit → row table
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


class StagingPlan(NamedTuple):
    tile_rows: int           # TH: the block's tile is TH × 32 pixels at all G levels
    chunk_bytes: int         # the channels a block folds: 64, 32 or 16 bytes


def staging_plan(g: int, window: int, f: int, dtype: torch.dtype) -> StagingPlan:
    """The kernel's tile and channel chunk for a (B, G·H·W, F) z of
    ``dtype`` at ``window``: the widest chunk of (64, 32, 16) bytes, none
    wider than F·size needs, for which some TH in (8, 4, 2, 1) fits the z
    rows with a halo of window // 2 pixels, the mask words and the bit
    table into a block's 227 KB (on the card a narrower chunk of a 64-byte
    row reads it at a fraction of the memory's rate, PERF.md §6). Of its
    tiles: two blocks per SM first, then the fewest bytes staged per pixel,
    then the taller: TH 4 and 64-byte chunks at the model's G 5, window 5,
    F 32 and 64. Raises, with the kNN's message, outside odd windows with
    G·win² ≤ 128, for a dtype other than f32 or bf16, and where none fits."""
    check_window(g, window)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"z must be float32 or bfloat16, got {dtype}")
    r, row = window // 2, f * (torch.finfo(dtype).bits // 8)
    nw = -(-(g * window * window) // 32)
    for chunk in (64, 32, 16):
        if chunk > 16 and chunk // 2 >= row:
            continue                          # a narrower chunk holds the row
        fits = []
        for th in (8, 4, 2, 1):
            staged = g * (th + 2 * r) * (32 + 2 * r) * chunk + nw * g * th * 32 * 4
            if staged + _TABLE_BYTES <= _cuda.SMEM_PER_BLOCK:
                per_sm = _cuda.SMEM_PER_SM // (staged + _TABLE_BYTES + 1024)
                fits.append((min(per_sm, 2), -staged / th, th))
        if fits:
            return StagingPlan(max(fits)[2], chunk)
    raise ValueError(f"no staging plan fits G={g}, window={window}")


def check_args(z: torch.Tensor, mask: torch.Tensor, grid_shape: Tuple[int, int, int],
               window: int) -> StagingPlan:
    """``masked_window_max_cuda``'s checks of its arguments, on any device
    and without a launch → its ``staging_plan``."""
    g, h, w = grid_shape
    if z.dim() != 3 or z.shape[1] != g * h * w:
        raise ValueError(f"z {tuple(z.shape)} does not match grid {grid_shape}")
    plan = staging_plan(g, window, z.shape[2], z.dtype)
    if not z.is_contiguous():
        raise ValueError("z must be contiguous")
    nw = -(-(g * window * window) // 32)
    if (mask.dtype != torch.int32 or not mask.is_contiguous()
            or mask.shape != (z.shape[0], nw, g, h, w)):
        raise ValueError(f"mask must be contiguous int32 {(z.shape[0], nw, g, h, w)}")
    return plan


def masked_window_max_cuda(z: torch.Tensor, mask: torch.Tensor,
                           grid_shape: Tuple[int, int, int],
                           window: int = 5) -> torch.Tensor:
    """The CUDA kernel: same contract as ``masked_window_max_plain`` for
    every shape ``check_args`` takes."""
    global launches
    g, h, w = grid_shape
    if not (z.is_cuda and mask.is_cuda):
        raise ValueError("masked_window_max_cuda takes CUDA tensors")
    plan = check_args(z, mask, grid_shape, window)
    out = torch.empty_like(z)
    lib = _cuda.load("masked_window_max")
    err = lib.masked_window_max(z.data_ptr(), mask.data_ptr(), out.data_ptr(), z.shape[0], g,
                                h, w, z.shape[2], window, plan.tile_rows, plan.chunk_bytes,
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
