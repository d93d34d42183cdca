"""3-D cost-volume U-Net: counterpart of
``pointmvsnet_tpu/models/volume_conv.py :: VolumeConv``."""

from __future__ import annotations

import torch
import torch.nn as nn

from pointmvsnet_tpu_torch.models.blocks import ConvBlock, DeconvBlock


class VolumeConv(nn.Module):
    """Three stride-2 down stages, transposed-conv up path with additive
    skips, and a final 1-channel conv (raw logits). Input (B, D, H, W, C)
    and output (B, D, H, W, 1) are channels-last; the convs run NCDHW."""

    def __init__(self, base_channels: int = 8, in_channels: int = 32,
                 norm: str = "bn", dtype: torch.dtype = torch.float32):
        super().__init__()
        c = base_channels
        kw = dict(norm=norm, rank=3, dtype=dtype)
        self.convs = nn.ModuleList([
            ConvBlock(in_channels, c, 3, 1, **kw),
            ConvBlock(c, 2 * c, 3, 2, **kw), ConvBlock(2 * c, 2 * c, 3, 1, **kw),
            ConvBlock(2 * c, 4 * c, 3, 2, **kw), ConvBlock(4 * c, 4 * c, 3, 1, **kw),
            ConvBlock(4 * c, 8 * c, 3, 2, **kw), ConvBlock(8 * c, 8 * c, 3, 1, **kw),
            ConvBlock(c, 1, 3, 1, norm="none", relu=False, rank=3, dtype=dtype),
        ])
        self.deconvs = nn.ModuleList([
            DeconvBlock(8 * c, 4 * c, 3, 2, norm, dtype=dtype),
            DeconvBlock(4 * c, 2 * c, 3, 2, norm, dtype=dtype),
            DeconvBlock(2 * c, c, 3, 2, norm, dtype=dtype),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cv = self.convs
        conv0 = cv[0](x.permute(0, 4, 1, 2, 3))
        conv1 = cv[2](cv[1](conv0))
        conv2 = cv[4](cv[3](conv1))
        conv3 = cv[6](cv[5](conv2))
        up2 = self.deconvs[0](conv3) + conv2
        up1 = self.deconvs[1](up2) + conv1
        up0 = self.deconvs[2](up1) + conv0
        return cv[7](up0).permute(0, 2, 3, 4, 1)
