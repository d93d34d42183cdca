"""Shared-weight 2-D feature pyramid: counterpart of
``pointmvsnet_tpu/models/image_conv.py :: ImageConv``."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from pointmvsnet_tpu_torch.models.blocks import ConvBlock

# (out-channel multiple of base, kernel, stride) of the 11 conv blocks
_LAYOUT = [(1, 3, 1), (1, 3, 1),
           (2, 5, 2), (2, 3, 1), (2, 3, 1),
           (4, 5, 2), (4, 3, 1), (4, 3, 1),
           (8, 5, 2), (8, 3, 1), (8, 3, 1)]
_TAPS = {1: "conv0", 4: "conv1", 7: "conv2", 10: "conv3"}


class ImageConv(nn.Module):
    """4-level pyramid: conv0 (C @1/1), conv1 (2C @1/2), conv2 (4C @1/4),
    conv3 (8C @1/8). Input and outputs are channels-last (N, H, W, C); the
    convs run NCHW. ``levels`` < 4 keeps the blocks up to conv<levels−1>
    (CasMVSNet's feature net is the first three levels)."""

    def __init__(self, base_channels: int = 8, norm: str = "bn",
                 dtype: torch.dtype = torch.float32, levels: int = 4):
        super().__init__()
        last = sorted(_TAPS)[levels - 1]
        blocks, cin = [], 3
        for mult, k, s in _LAYOUT[:last + 1]:
            blocks.append(ConvBlock(cin, mult * base_channels, k, s, norm,
                                    dtype=dtype))
            cin = mult * base_channels
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        x = x.permute(0, 3, 1, 2)
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in _TAPS:
                out[_TAPS[i]] = x.permute(0, 2, 3, 1)
        return out
