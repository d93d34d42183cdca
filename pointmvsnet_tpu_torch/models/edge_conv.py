"""DGCNN-style edge convolution over PointFlow's hypothesis points:
counterpart of ``pointmvsnet_tpu/models/edge_conv.py :: EdgeConv``.

The single (2C, F) kernel keeps the reference layout and is split as
W_c / W_n ("z-trick"): W·concat(x_i, x_j − x_i) = (x·W_n)_j + x_i·(W_c − W_n),
so the matmul runs once per point and only F-wide rows move.

Eval fast path (BatchNorm or no norm, with the kNN selection mask): eval
BN is a per-channel affine a·v + b and ReLU is monotone, so
max_k relu(a·z_k + b) = relu(max_k(a·z_k) + b); the neighbour reduction is
the masked window max of ``ops/edge.py`` (a CUDA kernel on the card), and
no (N, K, F) tensor exists. The gather path (training, no mask, or
GroupNorm) forms that tensor with ``gather_knn``; it is also the tests'
oracle. In training, BatchNorm takes f32 batch moments over (B, N, K)
(``blocks.bn_batch_stats``, flax semantics, over the global batch under
data parallelism) and casts its f32 result back to the compute dtype,
while GroupNorm returns f32, as in the JAX package; autograd
differentiates the gather (its backward is an ``index_add``), as XLA does
in the JAX package. The backward recomputes the gather path from z and
the centre term (in the compute dtype, with sync-BN's all-reduce again,
in the same order on every rank) instead of keeping its (B, N, K, F)
tensors: at the 640×512 training config they are 3.4 GB (F = 32) and 6.7
GB (F = 64) each at B = 4, and keeping three per EdgeConv does not fit
the card's 80 GB.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from pointmvsnet_tpu_torch.models.blocks import apply_norm, bn_batch_stats, bn_blend, make_norm
from pointmvsnet_tpu_torch.ops.edge import masked_window_max
from pointmvsnet_tpu_torch.ops.knn import gather_knn


class EdgeConv(nn.Module):
    """x (B, N, C), knn_idx (B, N, K) → (B, N, features); the edge feature
    is concat(x_i, x_j − x_i). ``mask`` / ``grid_shape`` / ``window``: the
    selection bitmask of ``ops.knn.window_knn_mask`` over the (G, H, W)
    grid, which enables the fast path for norm "bn" and "none" (GroupNorm
    always takes the gather path)."""

    def __init__(self, in_channels: int, features: int, norm: str = "bn",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        bound = (2 * in_channels) ** -0.5
        self.kernel = nn.Parameter(
            torch.empty(2 * in_channels, features).uniform_(-bound, bound))
        self.norm = make_norm(norm, features, 1)
        self.norm_kind = norm
        self.dtype = dtype

    def _bn_affine(self):
        """Eval BN as (mul, add) in the compute dtype, in flax's order."""
        dt, bn = self.dtype, self.norm
        mul = torch.rsqrt(bn.running_var.to(dt) + bn.eps) * bn.weight.to(dt)
        return mul, bn.running_mean.to(dt), bn.bias.to(dt)

    def forward(self, x: torch.Tensor, knn_idx: Optional[torch.Tensor], *,
                mask: Optional[torch.Tensor] = None,
                grid_shape: Optional[Tuple[int, int, int]] = None,
                window: int = 5) -> torch.Tensor:
        dt = self.dtype
        c = x.shape[-1]
        kernel = self.kernel.to(dt)
        x = x.to(dt)
        w_c, w_n = kernel[:c], kernel[c:]
        z = x @ w_n                                              # (B, N, F)
        cterm = x @ (w_c - w_n)

        if mask is not None and not self.training and self.norm_kind in ("bn", "none"):
            if self.norm_kind == "bn":
                mul, mean, bias = self._bn_affine()
                z2 = z * mul
                c2 = (cterm - mean) * mul + bias
            else:
                z2, c2 = z, cterm
            mx = masked_window_max(z2.contiguous(), mask, grid_shape, window)
            return F.relu(mx + c2)

        if self.training and torch.is_grad_enabled():
            out, stats = checkpoint(self._gather_max, z, cterm, knn_idx, use_reentrant=False)
        else:
            out, stats = self._gather_max(z, cterm, knn_idx)
        if stats is not None:
            bn_blend(self.norm, *stats)
        return out

    def _gather_max(self, z: torch.Tensor, cterm: torch.Tensor, knn_idx: torch.Tensor):
        """relu(norm(z[idx] + cterm)) maxed over K → (out, train-mode BN
        batch statistics or None)."""
        pre = gather_knn(z, knn_idx) + cterm[:, :, None, :]      # (B, N, K, F)
        stats = None
        if self.norm_kind == "bn" and self.training:
            y, mean, var = bn_batch_stats(self.norm, pre, [0, 1, 2])
            pre = y.to(pre.dtype)
            stats = (mean.detach(), var.detach())
        elif self.norm_kind == "bn":
            mul, mean, bias = self._bn_affine()
            pre = (pre - mean) * mul + bias
        elif self.norm_kind == "gn":
            pre = apply_norm(self.norm, pre.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return F.relu(pre).amax(dim=2), stats
