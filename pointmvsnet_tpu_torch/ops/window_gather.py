"""Windowed row gather: counterpart of the probe
``benchmarks/pallas_gather_probe.py`` (``pallas_gather`` and its Pallas
kernel ``_mk_pallas``).

The probe asks whether a coherent stream of row indices (the PointFlow
fetch's epipolar pattern) is served faster from a two-slab window than by
a plain row gather. ``prepare`` pads the table and splits the indices into
a slab index ``q`` per 512-row block and window-relative ``rel``;
``window_gather`` then computes ``out[n] = table_p[q[n // 512]·span +
rel[n]]``, which equals ``table[idx[n]]``. A CUDA tensor goes to the
hand-written kernel ``csrc/window_gather.cu`` (``window_gather_cuda``), a
CPU tensor to ``window_gather_plain``. Both raise on indices outside the
window instead of reading past it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from pointmvsnet_tpu_torch.ops import _cuda

BLOCK = 512        # rows per slab index, as in the probe

# launches of the CUDA kernel (only ``window_gather_cuda`` increments it)
launches = 0


def prepare(table: torch.Tensor, idx: torch.Tensor,
            span: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """table (R, W), idx (N,) with N a multiple of 512 → (table_p, q, rel):
    the table zero-padded to a multiple of ``span`` plus one more span (so
    slab q + 1 always exists), q (N / 512,) int32 = the block's smallest
    index // span, rel (N,) int32 = idx − q·span. rel < 2·span holds when
    every block's indices lie within ``span`` rows of each other."""
    n = idx.shape[0]
    if n % BLOCK:
        raise ValueError(f"{n} indices: want a multiple of {BLOCK}")
    pad = (-table.shape[0]) % span + span
    table_p = F.pad(table, (0, 0, 0, pad))
    ib = idx.reshape(n // BLOCK, BLOCK).long()
    q = ib.amin(dim=1) // span
    rel = (ib - (q * span)[:, None]).to(torch.int32).reshape(n)
    return table_p, q.to(torch.int32), rel


def _check(table_p: torch.Tensor, q: torch.Tensor, rel: torch.Tensor, span: int) -> None:
    n = rel.shape[0]
    if table_p.dim() != 2 or table_p.shape[0] % span:
        raise ValueError(f"table {tuple(table_p.shape)}: want (k·span, W), span {span}")
    if rel.dim() != 1 or n % BLOCK or q.shape != (n // BLOCK,):
        raise ValueError(f"rel {tuple(rel.shape)}, q {tuple(q.shape)}: want (N,), (N/{BLOCK},)")
    if n == 0:
        return
    lo, hi = torch.aminmax(rel)
    if int(lo) < 0 or int(hi) >= 2 * span:
        raise ValueError(f"rel in [{int(lo)}, {int(hi)}]: outside the two-slab "
                         f"window [0, {2 * span})")
    qlo, qhi = torch.aminmax(q)
    if int(qlo) < 0 or (int(qhi) + 2) * span > table_p.shape[0]:
        raise ValueError(f"q in [{int(qlo)}, {int(qhi)}]: window past the "
                         f"{table_p.shape[0]}-row table")


def window_gather_plain(table_p: torch.Tensor, q: torch.Tensor, rel: torch.Tensor,
                        span: int) -> torch.Tensor:
    """Plain version: one ``index_select`` of the rows q·span + rel."""
    _check(table_p, q, rel, span)
    rows = q.long().repeat_interleave(BLOCK) * span + rel.long()
    return table_p.index_select(0, rows)


def window_gather_cuda(table_p: torch.Tensor, q: torch.Tensor, rel: torch.Tensor,
                       span: int) -> torch.Tensor:
    """The CUDA kernel: same contract as ``window_gather_plain`` for a
    contiguous float32 table whose width is a multiple of 4 and int32
    indices. Raises on anything it does not take."""
    global launches
    if not (table_p.is_cuda and q.is_cuda and rel.is_cuda):
        raise ValueError("window_gather_cuda takes CUDA tensors")
    if table_p.dtype != torch.float32 or not table_p.is_contiguous():
        raise ValueError("table must be contiguous float32")
    if table_p.dim() != 2 or table_p.shape[1] % 4 or table_p.data_ptr() % 16:
        raise ValueError(f"table {tuple(table_p.shape)}: width must be a multiple "
                         f"of 4 and rows 16-byte aligned")
    if (q.dtype, rel.dtype) != (torch.int32, torch.int32) or not (
            q.is_contiguous() and rel.is_contiguous()):
        raise ValueError("q and rel must be contiguous int32")
    _check(table_p, q, rel, span)
    if table_p.shape[0] >= 2 ** 31 or rel.shape[0] >= 2 ** 31:
        raise ValueError("too many rows for int32 sizes")
    out = torch.empty((rel.shape[0], table_p.shape[1]), dtype=torch.float32,
                      device=table_p.device)
    lib = _cuda.load("window_gather")
    err = lib.window_gather(table_p.data_ptr(), q.data_ptr(), rel.data_ptr(),
                            out.data_ptr(), rel.shape[0], table_p.shape[1], span,
                            table_p.device.index, _cuda.stream_of(table_p))
    _cuda.check(lib, err, "window_gather")
    launches += 1
    return out


def window_gather(table_p: torch.Tensor, q: torch.Tensor, rel: torch.Tensor,
                  span: int) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if table_p.is_cuda:
        return window_gather_cuda(table_p, q, rel, span)
    if table_p.device.type == "cpu":
        return window_gather_plain(table_p, q, rel, span)
    raise ValueError(f"unsupported device {table_p.device}")
