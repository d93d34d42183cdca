"""JAX-package variables → the port's ``state_dict``, and seeded weights.

``jax_to_torch`` maps each flax path explicitly (no shape matching):
``params/img_conv/ConvBlock_3/Conv_0/kernel`` → ``img_conv.blocks.3.conv.weight``,
and so on for every module of ``PointMVSNet``. Layouts are the inverses of
``pointmvsnet_tpu/utils/torch_convert.py``: conv HWIO / DHWIO → OIHW /
OIDHW; flax ``ConvTranspose(transpose_kernel=True)`` (*sp, O, I) → torch
(I, O, *sp); Dense (I, O) → (O, I); BN scale / bias / mean / var →
weight / bias / running_mean / running_var; the EdgeConv (2C, F) kernel
is kept as it is.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

# (flax module path, torch module path, kernel kind); {0} is the index
_MODULES = [
    (r"img_conv/ConvBlock_(\d+)/Conv_0", "img_conv.blocks.{0}.conv", "conv"),
    (r"img_conv/ConvBlock_(\d+)/(?:BatchNorm|GroupNorm)_0", "img_conv.blocks.{0}.norm", None),
    (r"vol_conv/ConvBlock_(\d+)/Conv_0", "vol_conv.convs.{0}.conv", "conv"),
    (r"vol_conv/ConvBlock_(\d+)/(?:BatchNorm|GroupNorm)_0", "vol_conv.convs.{0}.norm", None),
    (r"vol_conv/DeconvBlock_(\d+)/ConvTranspose_0", "vol_conv.deconvs.{0}.conv", "conv"),
    (r"vol_conv/DeconvBlock_(\d+)/(?:BatchNorm|GroupNorm)_0", "vol_conv.deconvs.{0}.norm", None),
    (r"point_flow/core/EdgeConv_(\d+)", "point_flow.edge_convs.{0}", "edge"),
    (r"point_flow/core/EdgeConv_(\d+)/(?:BatchNorm|GroupNorm)_0",
     "point_flow.edge_convs.{0}.norm", None),
    (r"point_flow/core/SharedMLP_0/Dense_(\d+)", "point_flow.head.layers.{0}.linear", "dense"),
    (r"point_flow/core/SharedMLP_0/(?:BatchNorm|GroupNorm)_(\d+)",
     "point_flow.head.layers.{0}.norm", None),
]
_LEAVES = {"bias": "bias", "scale": "weight", "mean": "running_mean",
           "var": "running_var"}


def _convert_kernel(kind: str, w: np.ndarray) -> np.ndarray:
    if kind == "edge":
        return w
    if kind == "dense":
        return w.T
    # conv (*sp, I, O) → (O, I, *sp); transposed conv (*sp, O, I) → (I, O, *sp)
    return np.transpose(w, (w.ndim - 1, w.ndim - 2, *range(w.ndim - 2)))


def torch_name(path: str) -> tuple[str, str | None]:
    """flax path → (torch state_dict key, kernel kind or None)."""
    _, rest = path.split("/", 1)             # drop the collection
    module, leaf = rest.rsplit("/", 1)
    for pat, repl, kind in _MODULES:
        m = re.fullmatch(pat, module)
        if m:
            prefix = repl.format(*m.groups())
            if leaf == "kernel":
                return prefix + (".kernel" if kind == "edge" else ".weight"), kind
            return f"{prefix}.{_LEAVES[leaf]}", None
    raise KeyError(f"no torch counterpart for {path!r}")


def jax_to_torch(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat ``{"params/…": array, "batch_stats/…": array}`` → state_dict."""
    out = {}
    for path, arr in flat.items():
        name, kind = torch_name(path)
        arr = np.asarray(arr, np.float32)
        if kind is not None:
            arr = _convert_kernel(kind, arr)
        out[name] = torch.tensor(arr)
    return out


def load_jax_variables(model: torch.nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Load converted variables into ``model``; every parameter and BN
    statistic must be covered (only ``num_batches_tracked`` may be left)."""
    result = model.load_state_dict(jax_to_torch(flat), strict=False)
    missing = [k for k in result.missing_keys if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise ValueError(f"missing {missing}, unexpected {result.unexpected_keys}")


def init_params(model: torch.nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Seeded weights for ``model``, drawn on the CPU so every device gets
    the same values: kernels uniform in ±1/√fan_in (torch's default conv
    init), biases zero, BN scale in [0.5, 1.5), shift and running mean
    N(0, 0.3²), running var in [0.5, 1.5) — so eval BN is not an identity.
    → a CPU state_dict for ``model.load_state_dict``."""
    sd = {}
    for name, t in model.state_dict().items():
        shape, leaf = t.shape, name.rsplit(".", 1)[-1]

        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=generator)

        def normal(std):
            return std * torch.randn(shape, generator=generator)

        is_norm = ".norm." in name
        if leaf == "num_batches_tracked":
            sd[name] = torch.zeros_like(t, device="cpu")
        elif leaf == "running_mean" or (is_norm and leaf == "bias"):
            sd[name] = normal(0.3)
        elif leaf == "running_var" or (is_norm and leaf == "weight"):
            sd[name] = uniform(0.5, 1.5)
        elif leaf == "bias":
            sd[name] = torch.zeros(shape)
        else:
            if leaf == "kernel":                    # EdgeConv (in_dim, F)
                fan_in = shape[0]
            elif ".deconvs." in name:               # (I, O, *sp)
                fan_in = shape[0] * int(np.prod(shape[2:]))
            else:                                   # (O, I, *sp)
                fan_in = int(np.prod(shape[1:]))
            bound = fan_in ** -0.5
            sd[name] = uniform(-bound, bound)
    return sd
