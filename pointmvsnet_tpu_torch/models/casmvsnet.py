"""CasMVSNet (Gu et al., *Cascade Cost Volume for High-Resolution
Multi-View Stereo*, CVPR 2020, arXiv:1912.06378) on the port's modules.

Three stages, coarse to fine, at 1/4, 1/2 and full image resolution:

* **Features.** ``FeatureNet``: ImageConv's conv0-conv2 (the first three
  levels of Point-MVSNet's pyramid) and an FPN over them: stage 1 is
  ``out1(conv2)``; ``i2 = up2(conv2) + inner1(conv1)``, stage 2
  ``out2(i2)``; ``i3 = up2(i2) + inner2(conv0)``, stage 3 ``out3(i3)``
  (``up2`` nearest ×2; the out convs have no bias, the inner ones do).
* **Hypotheses.** Stage 1: ``ndepths[0]`` planes from the first to the
  last of the ``num_virtual_plane`` base planes (d_min, d_interval of the
  reference camera). Stage s > 1: the previous depth bilinearly resized to
  the image size (``stage<s>_input``), ``ndepths[s]`` samples evenly from
  d − D/2·r·Δ to d + D/2·r·Δ per pixel (Δ = (last − first base plane) /
  their count, r = ``interval_ratios[s]``), trilinearly resized to (D,
  H/scale, W/scale).
* **Cost and regression.** ``plane_sweep_volume`` (variance over the
  views; on the card at eval one CUDA kernel, ``csrc/plane_sweep.cu``,
  which writes the volume in the U-Net's dtype), one ``VolumeConv`` per stage, softmax over D, the expected depth
  over the stage's hypotheses, and the probability mass of the 4
  hypotheses around the regressed index (``regressed_confidence``).

Depth hypotheses, the warp, the softmax and the regression run in f32
(bf16's ulp at 600 mm is 4 mm, above stage 3's interval); the features
and the U-Nets in the model's ``dtype``. ``VolumeConv``'s final conv keeps
its bias, which the published network has not: a constant added to every
hypothesis's logit, it cancels in the softmax over D.

Eval only: no band- or view-parallel path. Under a profiler the forward
is ``cascade.features``, then per stage ``cascade.stage<n>`` around
``cascade.hypotheses``, ``cascade.sweep``, ``cascade.regularize`` and
``cascade.regress`` (``utils/profiler.py::span``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pointmvsnet_tpu_torch.models.image_conv import ImageConv
from pointmvsnet_tpu_torch.models.pointmvsnet import scale_cams
from pointmvsnet_tpu_torch.models.volume_conv import VolumeConv
from pointmvsnet_tpu_torch.ops.cost_volume import (
    depth_regression,
    plane_sweep_volume,
    regressed_confidence,
)
from pointmvsnet_tpu_torch.ops.geometry import cam_depth_range, depth_hypotheses
from pointmvsnet_tpu_torch.utils import profiler

STAGE_SCALES = (4, 2, 1)     # image size / stage size


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride, conv.padding)


class FeatureNet(nn.Module):
    """ImageConv's first three levels (base C: C, 2C, 4C channels at 1/1,
    1/2, 1/4) and the FPN → stage features (N, h, w, c) channels-last:
    4C @1/4, 2C @1/2, C @1/1."""

    def __init__(self, base_channels: int = 8, norm: str = "bn",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = base_channels
        self.img_conv = ImageConv(c, norm, dtype, levels=3)
        self.out1 = nn.Conv2d(4 * c, 4 * c, 1, bias=False)
        self.inner1 = nn.Conv2d(2 * c, 4 * c, 1)
        self.inner2 = nn.Conv2d(c, 4 * c, 1)
        self.out2 = nn.Conv2d(4 * c, 2 * c, 3, padding=1, bias=False)
        self.out3 = nn.Conv2d(4 * c, c, 3, padding=1, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        dt = self.dtype
        pyr = {k: f.permute(0, 3, 1, 2) for k, f in self.img_conv(x).items()}
        inner = pyr["conv2"]
        outs = [_conv(self.out1, inner, dt)]
        for lateral, lvl, out in ((self.inner1, "conv1", self.out2),
                                  (self.inner2, "conv0", self.out3)):
            inner = (F.interpolate(inner, scale_factor=2.0, mode="nearest")
                     + _conv(lateral, pyr[lvl], dt))
            outs.append(_conv(out, inner, dt))
        return [o.permute(0, 2, 3, 1) for o in outs]


def stage_hypotheses(depth: torch.Tensor, ndepth: int, interval: torch.Tensor,
                     height: int, width: int, scale: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The previous stage's depth (B, h', w') → (its bilinear resize to the
    image (B, H, W), the stage's per-pixel hypotheses (B, D, H/scale,
    W/scale)): D samples evenly spaced over ±D/2 of ``interval`` (B,)
    around it, trilinearly resized to the stage's grid."""
    cur = F.interpolate(depth[:, None], (height, width), mode="bilinear",
                        align_corners=False)[:, 0]
    half = (ndepth / 2 * interval)[:, None, None]
    lo, hi = cur - half, cur + half
    step = (hi - lo) / (ndepth - 1)
    k = torch.arange(ndepth, dtype=cur.dtype, device=cur.device)[None, :, None, None]
    samples = lo[:, None] + k * step[:, None]
    samples = F.interpolate(samples[:, None], (ndepth, height // scale, width // scale),
                            mode="trilinear", align_corners=False)[:, 0]
    return cur, samples


class CasMVSNet(nn.Module):
    """``forward`` takes images (B, V, H, W, 3) normalized and cams (B, V,
    2, 4, 4) at image resolution, view 0 the reference, H and W multiples
    of 32, and returns ``stage<n>_depth`` / ``stage<n>_confidence`` (B,
    H/scale, W/scale), ``stage<n>_input`` (B, H, W) for n > 1, and
    ``depth`` / ``confidence`` (stage 3's)."""

    crop_base = 32

    def __init__(self, img_base_channels: int = 8, vol_base_channels: int = 8,
                 ndepths: Sequence[int] = (48, 32, 8),
                 interval_ratios: Sequence[float] = (4.0, 2.0, 1.0),
                 norm: str = "bn", dtype: torch.dtype = torch.float32):
        super().__init__()
        c = img_base_channels
        self.features = FeatureNet(c, norm, dtype)
        self.cost_regs = nn.ModuleList(VolumeConv(vol_base_channels, ch, norm, dtype)
                                       for ch in (4 * c, 2 * c, c))
        self.ndepths = tuple(ndepths)
        self.interval_ratios = tuple(interval_ratios)
        self.dtype = dtype

    # ---- the entry points' interface (``Predictor``, ``test.py``) ----
    def eval_kwargs(self, cfg) -> Dict:
        return dict(num_virtual_plane=cfg.DATA.TEST.NUM_VIRTUAL_PLANE)

    @staticmethod
    def result_keys(preds) -> Tuple[str, str]:
        return "depth", "confidence"

    @staticmethod
    def export_maps(preds) -> Dict[str, str]:
        """MVSNet's export: the depth fusion reads and its confidence."""
        return {"init": "depth", "prob": "confidence"}

    def forward(self, images: torch.Tensor, cams: torch.Tensor,
                num_virtual_plane: int = 192) -> Dict[str, torch.Tensor]:
        b, v, height, width, _ = images.shape
        if height % 32 or width % 32:
            raise ValueError(f"input {height}x{width} must be divisible by 32 (stage 1 "
                             f"at 1/4 + 3-level volume U-Net); crop_mvs_input(base=32) "
                             f"produces compliant shapes")
        if any(d % 8 for d in self.ndepths):
            raise ValueError(f"ndepths {self.ndepths} must be divisible by 8 (volume "
                             f"U-Net strides)")
        cams = cams.float()
        with profiler.span("cascade.features"):
            feats = self.features(images.to(self.dtype).reshape(b * v, height, width, 3))
            feats = [f.reshape(b, v, *f.shape[1:]) for f in feats]
        d_min, d_int, _, _ = cam_depth_range(cams[:, 0])
        base = depth_hypotheses(d_min, d_int, num_virtual_plane)        # (B, N)
        delta = (base[:, -1] - base[:, 0]) / num_virtual_plane
        preds: Dict[str, torch.Tensor] = {}
        depth = None
        for s, (scale, ndepth, ratio) in enumerate(
                zip(STAGE_SCALES, self.ndepths, self.interval_ratios), start=1):
            with profiler.span(f"cascade.stage{s}"):
                with profiler.span("cascade.hypotheses"):
                    if depth is None:
                        first, last = base[:, :1], base[:, -1:]
                        k = torch.arange(ndepth, dtype=torch.float32, device=base.device)
                        hyp = first + k * ((last - first) / (ndepth - 1))     # (B, D)
                    else:
                        cur, hyp = stage_hypotheses(depth.detach(), ndepth, ratio * delta,
                                                    height, width, scale)
                        preds[f"stage{s}_input"] = cur
                f = feats[s - 1]
                with profiler.span("cascade.sweep"):
                    cost = plane_sweep_volume(
                        f, scale_cams(cams, f.shape[3] / width, f.shape[2] / height), hyp)
                with profiler.span("cascade.regularize"):
                    logits = self.cost_regs[s - 1](cost)[..., 0]           # (B, D, h, w)
                    del cost
                with profiler.span("cascade.regress"):
                    prob = torch.softmax(logits.float(), dim=1)
                    depth = depth_regression(prob, hyp)
                    preds[f"stage{s}_depth"] = depth
                    preds[f"stage{s}_confidence"] = regressed_confidence(prob)
        preds["depth"] = preds[f"stage{s}_depth"]
        preds["confidence"] = preds[f"stage{s}_confidence"]
        return preds
