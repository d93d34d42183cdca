"""Peaks of the card and the least time of the two hand-written kernels'
work, for their roofline shares.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit;
every share is printed beside the card's own limit. A kernel's bound
counts each input byte read once and each output byte written once, and
its operations from the work these inputs need (the masked max's from the
set bits of its mask); it is the larger of bytes over the memory's rate
and operations over the f32 rate (both kernels compute outside the tensor
cores). Copied from the program's on-card smoke test.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {               # per operand dtype, tensor cores where they apply
    "bfloat16": 989e12,
    "float16": 989e12,
    "float32": 67e12,        # without TF32
    "tf32": 495e12,
    "float8": 1979e12,
}
F32_FLOPS = PEAK_FLOPS["float32"]


def knn_bound(h: int, w: int, g: int, k: int, win: int):
    """(bytes, operations) of one windowed-kNN call over a (g, h, w) grid:
    coordinates in, indices and mask words out; 8 operations per (query,
    in-image candidate)."""
    p, r = g * h * w, win // 2
    nw = -(-(g * win * win) // 32)
    ny = sum(min(h - 1, y + r) - max(0, y - r) + 1 for y in range(h))
    nx = sum(min(w - 1, x + r) - max(0, x - r) + 1 for x in range(w))
    return p * 12 + p * k * 4 + p * nw * 4, 8 * g * g * ny * nx


def mwm_bound(points: int, features: int, elem_bytes: int, mask_words: int, set_bits: int):
    """(bytes, operations) of one masked-window-max call: z (points ×
    features) and the mask words in, the output out; one max per (set bit,
    channel)."""
    return 2 * points * features * elem_bytes + mask_words * 4, set_bits * features


def bound_ms(nbytes: float, ops: float):
    """→ (least milliseconds, "bytes" | "operations", whichever bounds it)."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"
