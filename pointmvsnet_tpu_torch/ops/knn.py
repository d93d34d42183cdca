"""Windowed kNN over PointFlow's hypothesis grid, and the neighbour gather:
counterpart of ``pointmvsnet_tpu/ops/knn.py`` (``window_knn``,
``gather_knn``, ``window_knn_mask_auto``) and of the Pallas kernel
``ops/pallas/knn.py``.

``window_knn_mask`` (eval) and ``window_knn_idx`` (training) dispatch on
the tensor's device: a CUDA tensor goes to a hand-written kernel
(``window_knn_cuda``), a CPU tensor to the plain version ``window_knn``.
The kernels take every shape the plain version takes, as the Pallas
kernel does: ``kernel_variant`` picks ``csrc/window_knn.cu`` (tuned for
the paper's k = 16, window 5) or ``csrc/window_knn_general.cu`` (any odd
window with G·win² ≤ 128 and k ≤ G·(⌊win/2⌋+1)²). All rank candidates by
the JAX package's packed key, so their indices and masks are bit-equal.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from pointmvsnet_tpu_torch.ops import _cuda

# launches of the CUDA kernels, in all and by variant (only
# ``window_knn_cuda`` increments them)
launches = 0
launches_by = {"tuned": 0, "general": 0}


def check_window(g: int, window: int) -> None:
    if window % 2 != 1:
        raise ValueError(f"window must be odd, got {window}")
    if g * window * window > 128:
        raise ValueError("the packed key holds at most 128 candidate ids")


def _check_grid(g: int, k: int, window: int) -> None:
    check_window(g, window)
    if g * (window // 2 + 1) ** 2 < k:
        raise ValueError("not enough in-bounds candidates at the corners")


def kernel_variant(g: int, k: int, window: int) -> str:
    """The CUDA kernel for (G, k, window): "tuned" (``csrc/window_knn.cu``)
    at k = 16, window 5 (so G ≤ 5), "general"
    (``csrc/window_knn_general.cu``) at every other shape the plain
    version takes. Raises where the plain version raises."""
    _check_grid(g, k, window)
    return "tuned" if (k, window) == (16, 5) else "general"


def tile_rows(g: int, window: int) -> int:
    """The general kernel's tile height TH for G levels at ``window``: the
    tallest of (8, 4, 2, 1) whose G·TH·32 points take at most 512 threads,
    one per point, and whose coordinates with a halo of window // 2 pixels
    (float4) fit 48 KB of shared memory; else 1 (G > 16 at window 1, where
    512 threads loop over the tile), which must fit a block's 227 KB."""
    check_window(g, window)
    r = window // 2
    smem = [g * (th + 2 * r) * (32 + 2 * r) * 16 for th in (8, 4, 2, 1)]
    for th, nbytes in zip((8, 4, 2, 1), smem):
        if g * th * 32 <= 512 and nbytes <= 48 * 1024:
            return th
    if smem[-1] > _cuda.SMEM_PER_BLOCK:
        raise ValueError(f"no tile fits G={g}, window={window}")
    return 1


def check_args(points: torch.Tensor, grid_shape: Tuple[int, int, int], k: int,
               window: int) -> str:
    """``window_knn_cuda``'s checks of its arguments, on any device and
    without a launch → its ``kernel_variant``."""
    g, h, w = grid_shape
    if points.dtype != torch.float32 or not points.is_contiguous():
        raise ValueError("points must be contiguous float32")
    if points.dim() != 3 or points.shape[1:] != (g * h * w, 3):
        raise ValueError(f"points {tuple(points.shape)} do not match grid {grid_shape}")
    variant = kernel_variant(g, k, window)
    if g * h * w * max(k, 1) >= 2 ** 31:
        raise ValueError("grid too large for int32 indices")
    return variant


def _int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2³²) → int32 with the same 32 bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def window_knn(points: torch.Tensor, grid_shape: Tuple[int, int, int], k: int,
               window: int = 5, with_mask: bool = False):
    """Plain version. points (B, G·H·W, 3) f32, g-major then row-major
    pixels → idx (B, P, k) int32 flat indices, nearest first; with
    ``with_mask`` also the (B, NW, G, H, W) selection bitplanes (bit s of
    word s // 32 set iff candidate s = gc·win² + dy·win + dx was chosen),
    stored as int32 with the uint32 bits."""
    g, h, w = grid_shape
    b = points.shape[0]
    r = window // 2
    _check_grid(g, k, window)
    dev = points.device
    pts = points.reshape(b, g, h, w, 3)
    q = pts.unbind(-1)                                       # 3 × (B, G, H, W)
    padded = F.pad(pts.permute(0, 1, 4, 2, 3), (r, r, r, r), value=1e15)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]

    keys = []
    for gc in range(g):
        for dy in range(window):
            for dx in range(window):
                c = padded[:, gc, :, dy:dy + h, dx:dx + w]   # (B, 3, H, W)
                e = [q[i] - c[:, None, i] for i in range(3)]
                # (dx² + dy²) + dz², the order of the kernel and the JAX sum
                d2 = (e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]
                inside = ((ys + dy - r >= 0) & (ys + dy - r < h)
                          & (xs + dx - r >= 0) & (xs + dx - r < w))
                d2 = torch.where(inside, d2, 1e30)
                cid = (gc * window + dy) * window + dx
                keys.append((d2.view(torch.int32) & ~0x7F) | cid)
    key = torch.stack(keys, dim=-1)                          # (B, G, H, W, C)
    nn_ = torch.topk(key, k, dim=-1, largest=False, sorted=True).indices

    gc = nn_ // (window * window)
    s = nn_ % (window * window)
    yc = ys[..., None] + s // window - r
    xc = xs[..., None] + s % window - r
    idx = (gc * (h * w) + yc * w + xc).to(torch.int32).reshape(b, g * h * w, k)
    if not with_mask:
        return idx
    nw = -(-(g * window * window) // 32)
    bit = torch.ones((), dtype=torch.int64, device=dev) << (nn_ % 32)
    planes = [_int32_bits(torch.where(nn_ // 32 == wi, bit, 0).sum(-1))
              for wi in range(nw)]
    return idx, torch.stack(planes, dim=1)


def window_knn_cuda(points: torch.Tensor, grid_shape: Tuple[int, int, int],
                    k: int = 16, window: int = 5, variant: str = ""):
    """The CUDA kernels: same contract as ``window_knn(..., with_mask=True)``
    for every shape it takes. ``variant`` "general" runs the general kernel
    at the tuned kernel's shape too (to compare the two); by default
    ``kernel_variant`` picks. Raises on anything the kernels do not take."""
    global launches
    g, h, w = grid_shape
    if not points.is_cuda:
        raise ValueError("window_knn_cuda takes a CUDA tensor")
    chosen = check_args(points, grid_shape, k, window)
    variant = variant or chosen
    if variant not in ("tuned", "general") or (variant == "tuned" and chosen != "tuned"):
        raise ValueError(f"variant {variant!r} does not take k={k}, window={window}")
    b = points.shape[0]
    nw = -(-(g * window * window) // 32)
    idx = torch.empty((b, g * h * w, k), dtype=torch.int32, device=points.device)
    mask = torch.empty((b, nw, g, h, w), dtype=torch.int32, device=points.device)
    stream = _cuda.stream_of(points)
    if variant == "tuned":
        lib = _cuda.load("window_knn")
        err = lib.window_knn(points.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                             b, g, h, w, points.device.index, stream)
    else:
        lib = _cuda.load("window_knn_general")
        err = lib.window_knn_general(points.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                                     b, g, h, w, k, window, tile_rows(g, window),
                                     points.device.index, stream)
    _cuda.check(lib, err, f"window_knn ({variant})")
    launches += 1
    launches_by[variant] += 1
    return idx, mask


def window_knn_mask(points: torch.Tensor, grid_shape: Tuple[int, int, int],
                    k: int = 16, window: int = 5):
    """→ (idx, mask): the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if points.is_cuda:
        return window_knn_cuda(points, grid_shape, k, window)
    if points.device.type == "cpu":
        return window_knn(points, grid_shape, k, window, with_mask=True)
    raise ValueError(f"unsupported device {points.device}")


def window_knn_idx(points: torch.Tensor, grid_shape: Tuple[int, int, int],
                   k: int = 16, window: int = 5) -> torch.Tensor:
    """→ idx alone (training's gather path): the CUDA kernel, whose mask
    goes unused, for a CUDA tensor; the plain version for a CPU tensor."""
    if points.is_cuda:
        return window_knn_cuda(points, grid_shape, k, window)[0]
    if points.device.type == "cpu":
        return window_knn(points, grid_shape, k, window)
    raise ValueError(f"unsupported device {points.device}")


def gather_knn(features: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """features (B, P, C), indices (B, N, K) → (B, N, K, C) with
    out[b, n, k] = features[b, indices[b, n, k]]."""
    b, p, c = features.shape
    _, n, k = indices.shape
    offs = (torch.arange(b, device=features.device) * p)[:, None, None]
    flat = (indices.long() + offs).reshape(-1)
    return features.reshape(b * p, c).index_select(0, flat).reshape(b, n, k, c)
