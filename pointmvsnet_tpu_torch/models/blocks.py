"""Conv / deconv / per-point MLP blocks with BatchNorm, GroupNorm or no norm:
counterpart of ``pointmvsnet_tpu/models/blocks.py``.

Parameters stay float32 and are cast to the block's compute ``dtype`` in
``forward``, as flax's ``dtype=`` does. Convs pad k//2 on both sides;
deconvs are ``ConvTranspose(k, s, padding=k//2, output_padding=s-1)``. GN
uses gcd(8, C) groups. Norm arithmetic runs in f32. As the JAX package's
``_norm_layer`` does, a norm in training mode returns f32 and one in eval
mode returns the compute dtype; the next conv or dense casts its input to
the compute dtype again. The convs run NCHW / NCDHW; ``SharedMLP`` takes
channels-last (B, N, C).

BatchNorm (eps 1e-5) keeps ``nn.BatchNorm*d``'s parameters and buffers but
not its training arithmetic: in eval mode it normalizes by the running
statistics; in training mode ``bn_train`` follows flax's ``BatchNorm``
(batch mean and E[x²] − E[x]² clamped at 0, in f32; running statistics
blended with momentum 0.9 using the *biased* batch variance, where torch's
own module would use the unbiased one). Under data parallelism the batch
moments are those of the global batch (sync-BN, ``bn_moments``), so the
running statistics stay equal on every rank.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from pointmvsnet_tpu_torch.parallel import distributed

_BN = {1: nn.BatchNorm1d, 2: nn.BatchNorm2d, 3: nn.BatchNorm3d}


def make_norm(norm: str, channels: int, rank: int = 1) -> nn.Module | None:
    if norm == "bn":
        return _BN[rank](channels, eps=1e-5)
    if norm == "gn":
        return nn.GroupNorm(math.gcd(8, channels), channels, eps=1e-5)
    if norm == "none":
        return None
    raise ValueError(f"Unknown norm {norm!r}")


BN_MOMENTUM = 0.9      # flax's: running = 0.9 · running + 0.1 · batch


def bn_moments(x: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 mean and E[x²] − E[x]² (clamped at 0) of ``x`` over ``dims`` and
    over every rank's shard of the batch: the sums and sums of squares go
    through one differentiable all-reduce (the identity without a process
    group) and are divided by the global element count."""
    xf = x.float()
    c = xf.shape[next(d for d in range(x.dim()) if d not in dims)]
    count = (x.numel() // c) * distributed.world_size()
    sums = distributed.all_reduce_sum(torch.cat([xf.sum(dims), xf.square().sum(dims)]))
    mean = sums[:c] / count
    var = (sums[c:] / count - mean.square()).clamp_min(0.0)
    return mean, var


def bn_batch_stats(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor, dims):
    """Train-mode BatchNorm arithmetic of flax over the reduction ``dims``
    of ``x`` (the channels are the remaining dim): ``bn_moments`` and the
    f32 normalization. → (y in f32, mean, var); the running statistics are
    left alone."""
    mean, var = bn_moments(x, dims)
    shape = [1] * x.dim()
    ch = next(d for d in range(x.dim()) if d not in dims)
    shape[ch] = -1
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (x.float() - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    return y, mean, var


@torch.no_grad()
def bn_blend(bn: nn.modules.batchnorm._BatchNorm, mean: torch.Tensor,
             var: torch.Tensor) -> None:
    """Blend batch statistics into the running ones, in place."""
    bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1.0 - BN_MOMENTUM) * mean)
    bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1.0 - BN_MOMENTUM) * var)


def bn_train(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
             dims) -> torch.Tensor:
    """Train-mode BatchNorm with flax semantics: ``bn_batch_stats``, then
    the running statistics blended."""
    y, mean, var = bn_batch_stats(bn, x, dims)
    bn_blend(bn, mean, var)
    return y


def apply_norm(layer: nn.Module | None, x: torch.Tensor) -> torch.Tensor:
    """Channels at dim 1. Training mode returns f32: BN is ``bn_train``, GN
    runs on an f32 copy. Eval mode returns ``x``'s dtype: BN takes a
    low-precision input with f32 stats directly (its arithmetic is f32), GN
    runs on an f32 copy and casts back."""
    if layer is None:
        return x
    if isinstance(layer, nn.GroupNorm):
        y = layer(x.float())
        return y if layer.training else y.to(x.dtype)
    if layer.training:
        return bn_train(layer, x, [0, *range(2, x.dim())])
    return layer(x)


class ConvBlock(nn.Module):
    """2-D or 3-D conv (+norm)(+relu) over (B, C, *spatial)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                 norm: str = "bn", relu: bool = True, rank: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = {2: nn.Conv2d, 3: nn.Conv3d}[rank]
        self.conv = conv(cin, cout, kernel_size, stride, padding=kernel_size // 2,
                         bias=norm == "none")
        self.norm = make_norm(norm, cout, rank)
        self.relu = relu
        self.dtype = dtype
        self._fn = {2: F.conv2d, 3: F.conv3d}[rank]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        bias = None if c.bias is None else c.bias.to(self.dtype)
        x = self._fn(x.to(self.dtype), c.weight.to(self.dtype), bias,
                     c.stride, c.padding)
        x = apply_norm(self.norm, x)
        return F.relu(x) if self.relu else x


class DeconvBlock(nn.Module):
    """3-D transposed conv (+norm)(+relu) over (B, C, D, H, W)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 2,
                 norm: str = "bn", relu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.ConvTranspose3d(cin, cout, kernel_size, stride,
                                       padding=kernel_size // 2,
                                       output_padding=stride - 1,
                                       bias=norm == "none")
        self.norm = make_norm(norm, cout, 3)
        self.relu = relu
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        bias = None if c.bias is None else c.bias.to(self.dtype)
        x = F.conv_transpose3d(x.to(self.dtype), c.weight.to(self.dtype), bias,
                               c.stride, c.padding, c.output_padding)
        x = apply_norm(self.norm, x)
        return F.relu(x) if self.relu else x


class _Dense(nn.Module):
    def __init__(self, cin: int, cout: int, norm: str):
        super().__init__()
        self.linear = nn.Linear(cin, cout, bias=norm == "none")
        self.norm = make_norm(norm, cout, 1)


class SharedMLP(nn.Module):
    """Per-point MLP over channels-last (B, N, C): Linear (+norm)(+relu) per
    layer; the last layer's norm and relu follow ``last_norm`` /
    ``last_relu``."""

    def __init__(self, cin: int, features: Sequence[int], norm: str = "bn",
                 last_relu: bool = True, last_norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n = len(features)
        chans = [cin, *features]
        self.layers = nn.ModuleList(
            _Dense(chans[i], chans[i + 1],
                   norm if (last_norm or i < n - 1) else "none")
            for i in range(n))
        self.last_relu = last_relu
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            lin = layer.linear
            bias = None if lin.bias is None else lin.bias.to(self.dtype)
            x = F.linear(x.to(self.dtype), lin.weight.to(self.dtype), bias)
            if layer.norm is not None:
                x = apply_norm(layer.norm, x.transpose(1, 2)).transpose(1, 2)
            if self.last_relu or i < n - 1:
                x = F.relu(x)
        return x
