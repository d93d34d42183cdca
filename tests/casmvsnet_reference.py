"""Plain PyTorch reference of CasMVSNet (Gu, Fan, Zhu, Dai, Tan, Tan,
*Cascade Cost Volume for High-Resolution Multi-View Stereo*, CVPR 2020,
arXiv:1912.06378; github.com/alibaba/cascade-stereo, ``CasMVSNet/``),
the forward at eval, written from the paper's equations and the release's
``models/cas_mvsnet.py`` and ``models/module.py`` as remembered. It
imports nothing of the measured program and no JAX; f32 unless asked for
another precision. ``state_dict`` keys are the program's
(``pointmvsnet_tpu_torch/models/casmvsnet.py``) but for the final conv of
each stage's U-Net, which has no bias here (the published network's).

Layouts: images (B, V, H, W, 3) normalized, cams (B, V, 2, 4, 4) with
cam[0] the world→camera extrinsic, cam[1, :3, :3] = K and cam[1, 3] =
[d_min, d_interval, d_num, d_max]; view 0 the reference; H and W
multiples of 32.

Choices the release leaves open or makes otherwise (the configuration
file lists them under ``assumed``):

* both resizes of the hypotheses use ``align_corners=False`` (the
  release's ``Align_Corners_Range``);
* the per-pixel range d ± D/2·r·Δ is not clamped to the depth range (the
  release also carries a clamped variant, commented out);
* the warp has no z > 0 gate and samples with ``grid_sample(bilinear,
  zeros, align_corners=True)``, pixel centres at integer coordinates;
* the homography src_proj · ref_proj⁻¹ is composed in float64 and rounded
  once to float32 (the release inverts in float32).

``Precision``: "f32" (the reference), "bf16" (the operands of every
convolution cast to bfloat16 and activations held in it, as the program's
bf16 configuration; the warp, softmax and regression stay f32) or "fp8"
(e4m3 with a per-tensor scale, computed in f32: the control one precision
below bf16).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.bfloat16 if name == "bf16" else torch.float32

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "bf16":
            return x.to(torch.bfloat16)
        x = x.float()
        if self.name == "fp8":
            scale = FP8_MAX / x.abs().amax().clamp_min(1e-30)
            return (x * scale).to(torch.float8_e4m3fn).float() / scale
        return x


class ConvBnReLU(nn.Module):
    """conv (no bias) + BatchNorm + ReLU, 2-D or 3-D (the release's
    ``Conv2d`` / ``Conv3d``)."""

    def __init__(self, cin, cout, k, stride, prec, rank=2):
        super().__init__()
        self.conv = {2: nn.Conv2d, 3: nn.Conv3d}[rank](cin, cout, k, stride, padding=k // 2,
                                                       bias=False)
        self.norm = {2: nn.BatchNorm2d, 3: nn.BatchNorm3d}[rank](cout, eps=1e-5)
        self.prec = prec
        self.fn = {2: F.conv2d, 3: F.conv3d}[rank]

    def forward(self, x):
        p, c = self.prec, self.conv
        return F.relu(self.norm(self.fn(p(x), p(c.weight), None, c.stride, c.padding)))


class DeconvBnReLU(nn.Module):
    """3-D transposed conv (k 3, stride 2, output padding 1) + BN + ReLU."""

    def __init__(self, cin, cout, prec):
        super().__init__()
        self.conv = nn.ConvTranspose3d(cin, cout, 3, 2, padding=1, output_padding=1, bias=False)
        self.norm = nn.BatchNorm3d(cout, eps=1e-5)
        self.prec = prec

    def forward(self, x):
        p, c = self.prec, self.conv
        return F.relu(self.norm(F.conv_transpose3d(p(x), p(c.weight), None, c.stride,
                                                   c.padding, c.output_padding)))


class _Blocks(nn.Module):
    """conv0 (C: two 3×3), conv1 (2C: 5×5 stride 2, two 3×3), conv2 (4C:
    the same)."""

    def __init__(self, c, prec):
        super().__init__()
        layout = [(c, 3, 1), (c, 3, 1), (2 * c, 5, 2), (2 * c, 3, 1), (2 * c, 3, 1),
                  (4 * c, 5, 2), (4 * c, 3, 1), (4 * c, 3, 1)]
        blocks, cin = [], 3
        for cout, k, s in layout:
            blocks.append(ConvBnReLU(cin, cout, k, s, prec))
            cin = cout
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in (1, 4, 7):
                outs.append(x)
        return outs                                   # conv0, conv1, conv2 (NCHW)


class FeatureNet(nn.Module):
    """The release's ``FeatureNet(arch_mode="fpn")``: per view (N, 3, H, W)
    → [stage1 (4C @1/4), stage2 (2C @1/2), stage3 (C @1/1)]."""

    def __init__(self, c, prec):
        super().__init__()
        self.img_conv = _Blocks(c, prec)
        self.out1 = nn.Conv2d(4 * c, 4 * c, 1, bias=False)
        self.inner1 = nn.Conv2d(2 * c, 4 * c, 1, bias=True)
        self.inner2 = nn.Conv2d(c, 4 * c, 1, bias=True)
        self.out2 = nn.Conv2d(4 * c, 2 * c, 3, padding=1, bias=False)
        self.out3 = nn.Conv2d(4 * c, c, 3, padding=1, bias=False)
        self.prec = prec

    def _c(self, conv, x):
        p = self.prec
        bias = None if conv.bias is None else conv.bias.to(p.dtype)
        return F.conv2d(p(x), p(conv.weight), bias, conv.stride, conv.padding)

    def forward(self, x):
        conv0, conv1, conv2 = self.img_conv(x)
        intra = conv2
        stage1 = self._c(self.out1, intra)
        intra = F.interpolate(intra, scale_factor=2, mode="nearest") + self._c(self.inner1, conv1)
        stage2 = self._c(self.out2, intra)
        intra = F.interpolate(intra, scale_factor=2, mode="nearest") + self._c(self.inner2, conv0)
        stage3 = self._c(self.out3, intra)
        return [stage1, stage2, stage3]


class CostRegNet(nn.Module):
    """The release's ``CostRegNet``: a 3-D U-Net, base 8, three stride-2
    levels, additive skips, a final 3×3×3 conv to one channel, no bias.
    Module names follow the program's ``VolumeConv``."""

    def __init__(self, cin, c, prec):
        super().__init__()
        kw = dict(prec=prec, rank=3)
        self.convs = nn.ModuleList([
            ConvBnReLU(cin, c, 3, 1, **kw),
            ConvBnReLU(c, 2 * c, 3, 2, **kw), ConvBnReLU(2 * c, 2 * c, 3, 1, **kw),
            ConvBnReLU(2 * c, 4 * c, 3, 2, **kw), ConvBnReLU(4 * c, 4 * c, 3, 1, **kw),
            ConvBnReLU(4 * c, 8 * c, 3, 2, **kw), ConvBnReLU(8 * c, 8 * c, 3, 1, **kw),
            _Prob(c, prec)])
        self.deconvs = nn.ModuleList([DeconvBnReLU(8 * c, 4 * c, prec),
                                      DeconvBnReLU(4 * c, 2 * c, prec),
                                      DeconvBnReLU(2 * c, c, prec)])

    def forward(self, x):                              # (B, C, D, H, W)
        cv = self.convs
        conv0 = cv[0](x)
        conv2 = cv[2](cv[1](conv0))
        conv4 = cv[4](cv[3](conv2))
        x = cv[6](cv[5](conv4))
        x = conv4 + self.deconvs[0](x)
        x = conv2 + self.deconvs[1](x)
        x = conv0 + self.deconvs[2](x)
        return cv[7](x)                                # (B, 1, D, H, W)


class _Prob(nn.Module):
    def __init__(self, c, prec):
        super().__init__()
        self.conv = nn.Conv3d(c, 1, 3, 1, padding=1, bias=False)
        self.prec = prec

    def forward(self, x):
        p = self.prec
        return F.conv3d(p(x), p(self.conv.weight), None, 1, 1)


def proj_matrix(cam: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, 2, 4, 4) → the release's 4×4 projection [K·[R|t]; 0 0 0 1] in
    float64, K's first two rows scaled by ``scale``."""
    k = cam[:, 1, :3, :3].double().clone()
    k[:, :2] *= scale
    out = cam[:, 0].double().clone()
    out[:, :3, :4] = k @ cam[:, 0, :3, :4].double()
    return out


def homo_warping(src_fea, src_proj, ref_proj, depth_values):
    """The release's ``homo_warping``: src_fea (B, C, H, W), projections
    (B, 4, 4) float64, depth_values (B, D, H, W) → (B, C, D, H, W) f32."""
    b, c, h, w = src_fea.shape
    d = depth_values.shape[1]
    proj = (src_proj @ torch.inverse(ref_proj)).float()
    rot, trans = proj[:, :3, :3], proj[:, :3, 3:4]
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=src_fea.device),
                          torch.arange(w, dtype=torch.float32, device=src_fea.device),
                          indexing="ij")
    xyz = torch.stack((x.reshape(-1), y.reshape(-1), torch.ones(h * w, device=x.device)))
    rot_xyz = torch.matmul(rot, xyz[None].repeat(b, 1, 1))                 # (B, 3, HW)
    rot_depth_xyz = rot_xyz[:, :, None] * depth_values.reshape(b, 1, d, h * w)
    proj_xyz = rot_depth_xyz + trans.reshape(b, 3, 1, 1)
    proj_xy = proj_xyz[:, :2] / proj_xyz[:, 2:3]
    gx = proj_xy[:, 0] / ((w - 1) / 2) - 1
    gy = proj_xy[:, 1] / ((h - 1) / 2) - 1
    grid = torch.stack((gx, gy), dim=3)                                    # (B, D, HW, 2)
    warped = F.grid_sample(src_fea.float(), grid.reshape(b, d * h, w, 2), mode="bilinear",
                           padding_mode="zeros", align_corners=True)
    return warped.reshape(b, c, d, h, w)


def depth_regression(p, depth_values):
    if depth_values.dim() <= 2:
        depth_values = depth_values.reshape(*depth_values.shape, 1, 1)
    return torch.sum(p * depth_values, 1)


class CasMVSNet(nn.Module):
    def __init__(self, img_base_channels=8, vol_base_channels=8, ndepths=(48, 32, 8),
                 interval_ratios=(4.0, 2.0, 1.0), precision: str = "f32"):
        super().__init__()
        self.prec = Precision(precision)
        c = img_base_channels
        self.features = FeatureNet(c, self.prec)
        self.cost_regs = nn.ModuleList(CostRegNet(ch, vol_base_channels, self.prec)
                                       for ch in (4 * c, 2 * c, c))
        self.ndepths, self.ratios = tuple(ndepths), tuple(interval_ratios)

    def forward(self, images, cams, num_virtual_plane: int = 192,
                stage_inputs: Optional[Dict[int, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """``stage_inputs`` {stage s > 1: depth (B, H, W)}: stage s starts
        from the depth given instead of the previous stage's."""
        b, v, height, width, _ = images.shape
        cams = cams.float()
        feats = [self.features(images[:, i].permute(0, 3, 1, 2).float()) for i in range(v)]
        d_min, d_int = cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1]
        depth_values = (d_min[:, None] + torch.arange(num_virtual_plane, dtype=torch.float32,
                                                      device=images.device) * d_int[:, None])
        depth_interval = (depth_values[:, -1] - depth_values[:, 0]) / num_virtual_plane
        out: Dict[str, torch.Tensor] = {}
        depth = None
        for s, (scale, nd, ratio) in enumerate(zip((4, 2, 1), self.ndepths, self.ratios),
                                               start=1):
            if depth is None:
                lo, hi = depth_values[:, 0], depth_values[:, -1]
                step = (hi - lo) / (nd - 1)
                samples = lo[:, None] + torch.arange(nd, device=lo.device)[None] * step[:, None]
                samples = samples[:, :, None, None].repeat(1, 1, height, width)
            else:
                cur = (stage_inputs[s].float() if stage_inputs and s in stage_inputs else
                       F.interpolate(depth.detach()[:, None], [height, width], mode="bilinear",
                                     align_corners=False)[:, 0])
                out[f"stage{s}_input"] = cur
                half = (nd / 2 * (ratio * depth_interval))[:, None, None]
                lo, hi = cur - half, cur + half
                step = (hi - lo) / (nd - 1)
                samples = lo[:, None] + (torch.arange(nd, device=lo.device)
                                         .reshape(1, -1, 1, 1) * step[:, None])
            hyp = F.interpolate(samples[:, None], [nd, height // scale, width // scale],
                                mode="trilinear", align_corners=False)[:, 0]
            ref_proj = proj_matrix(cams[:, 0], 1.0 / scale)
            ref = feats[0][s - 1].float()
            vol_sum = ref[:, :, None].repeat(1, 1, nd, 1, 1)
            sq_sum = vol_sum ** 2
            for i in range(1, v):
                warped = homo_warping(feats[i][s - 1], proj_matrix(cams[:, i], 1.0 / scale),
                                      ref_proj, hyp)
                vol_sum = vol_sum + warped
                sq_sum = sq_sum + warped ** 2
            variance = sq_sum / v - (vol_sum / v) ** 2
            del vol_sum, sq_sum
            logits = self.cost_regs[s - 1](variance)[:, 0]
            del variance
            prob = F.softmax(logits.float(), dim=1)
            depth = depth_regression(prob, hyp)
            sum4 = 4 * F.avg_pool3d(F.pad(prob[:, None], (0, 0, 0, 0, 1, 2)), (4, 1, 1),
                                    stride=1, padding=0)[:, 0]
            index = depth_regression(prob, torch.arange(nd, device=prob.device,
                                                        dtype=torch.float32)).long()
            index = index.clamp(min=0, max=nd - 1)
            out[f"stage{s}_depth"] = depth
            out[f"stage{s}_confidence"] = torch.gather(sum4, 1, index[:, None])[:, 0]
        out["depth"], out["confidence"] = out["stage3_depth"], out["stage3_confidence"]
        return out


def build(model_cfg: Dict, precision: str = "f32") -> CasMVSNet:
    """A configuration's ``model`` block (the program's MODEL keys) → the
    reference, weights uninitialized (load a state_dict)."""
    c = model_cfg["CASCADE"]
    return CasMVSNet(model_cfg["IMG_BASE_CHANNELS"], model_cfg["VOL_BASE_CHANNELS"],
                     tuple(c["NDEPTHS"]), tuple(c["DEPTH_INTERVAL_RATIOS"]), precision)


def program_weights(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference's weights → the program's: each U-Net's final conv gets
    its bias, zero."""
    out = dict(state)
    for k, t in state.items():
        if k.startswith("cost_regs.") and k.endswith(".convs.7.conv.weight"):
            out[k[:-len("weight")] + "bias"] = torch.zeros(1, dtype=t.dtype, device=t.device)
    return out


@torch.no_grad()
def calibrate_bn(net: CasMVSNet, images, cams, num_virtual_plane: int) -> None:
    """Every BatchNorm's running statistics set to the batch statistics of
    one training-mode forward over ``images`` (each layer then normalizes
    what reaches it, as a trained network's do)."""
    bns = [m for m in net.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for bn in bns:
        bn.momentum = 1.0
    net.train()
    try:
        net(images, cams, num_virtual_plane)
    finally:
        for bn in bns:
            bn.momentum = 0.1
        net.eval()


def flops_inputs(views: int, height: int, width: int, device="meta"):
    """(images, cams) of one map at B = 1 on ``device`` (the operation
    count's meta tensors)."""
    return (torch.empty(1, views, height, width, 3, device=device),
            torch.empty(1, views, 2, 4, 4, device=device))


def stage_grids(height: int, width: int, ndepths: Sequence[int]):
    """(D, h, w) of each stage at an image of height × width."""
    return [(d, height // s, width // s) for d, s in zip(ndepths, (4, 2, 1))]
