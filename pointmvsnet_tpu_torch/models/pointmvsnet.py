"""Point-MVSNet forward: coarse plane sweep + iterative PointFlow.
Counterpart of ``pointmvsnet_tpu/models/pointmvsnet.py`` (``scale_cams``,
``hypothesis_points``, ``PointFlowCore``, ``PointFlow``, ``PointMVSNet``).

Input images are resized by ``coarse_img_scale`` for the coarse stage,
whose features come out at 1/4 of that, so the coarse depth map is 1/8 of
the input. Each flow iteration at ``img_scales[i]`` upsamples the previous
depth and refines it by the expected residual over 2m+1 hypotheses per
pixel, ``inter_scales[i]`` depth intervals apart along the viewing ray.

``flow_chunk_rows`` > 0 refines each flow map in row bands of that
height with an 8-row halo (``banded_point_flow``, the counterpart of the
JAX package's ``PointFlow``), at eval and in training; at eval a band
group shares the bands of one map out over its ranks, and a view group
shares out the cost volume's views (``parallel/view_parallel.py``).
``flow_chunk_rows`` -1 (the JAX package's AUTO height, chosen for the
TPU's VMEM, and unbanded in its training) and 0 are unbanded.
``model.train()`` selects the training forward of the JAX package's
``train=True``: batch statistics in every BatchNorm (per band where the
map is banded), the kNN indices alone and EdgeConv's gather path (the
masked-max fast path is eval only), the image pyramid run anew for every
flow iteration, and no gradient into the kNN or ``flowN_input``.

Under a profiler (``utils/profiler.py::span``) the forward is a
``model.coarse`` span and one ``model.flow<n>`` span per iteration; each
PointFlow call (each band, where banded) is ``point_flow.fetch``,
``point_flow.knn``, ``point_flow.edge_conv`` and ``point_flow.head``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from pointmvsnet_tpu_torch.models.blocks import SharedMLP
from pointmvsnet_tpu_torch.models.edge_conv import EdgeConv
from pointmvsnet_tpu_torch.models.image_conv import ImageConv
from pointmvsnet_tpu_torch.models.volume_conv import VolumeConv
from pointmvsnet_tpu_torch.ops.cost_volume import (
    depth_regression,
    photometric_confidence,
    plane_sweep_volume,
)
from pointmvsnet_tpu_torch.ops.geometry import (
    cam_depth_range,
    cam_extrinsics,
    cam_intrinsics,
    depth_hypotheses,
    pixel_grid,
    unproject_pixels,
)
from pointmvsnet_tpu_torch.ops.knn import window_knn_idx, window_knn_mask
from pointmvsnet_tpu_torch.ops.sampling import (
    fetch_features_perlevel,
    regular_grid_sample,
    resize_bilinear,
)
from pointmvsnet_tpu_torch.parallel import distributed
from pointmvsnet_tpu_torch.parallel.view_parallel import view_sharded_plane_sweep
from pointmvsnet_tpu_torch.utils import profiler

HALO = 8     # rows above and below a flow band: ≥ the ±6-row reach of three EdgeConvs


def scale_cams(cams: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """Scale the intrinsics rows of cams (..., 2, 4, 4) for an image resize."""
    out = cams.clone()
    out[..., 1, 0, :3] *= sx
    out[..., 1, 1, :3] *= sy
    return out


def _resize_views(images: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, V, H, W, C) → (B, V, h, w, C), bilinear with antialiasing, which
    equals ``jax.image.resize(method="bilinear")``. Computed in f32 and
    cast back to the input's dtype: PyTorch's CPU backend has no bf16
    antialiased resize, and one code path serves both devices."""
    b, v, hh, ww, c = images.shape
    x = images.reshape(b * v, hh, ww, c).permute(0, 3, 1, 2).float()
    x = F.interpolate(x, (h, w), mode="bilinear", align_corners=False,
                      antialias=True)
    return x.permute(0, 2, 3, 1).reshape(b, v, h, w, c).to(images.dtype)


def hypothesis_points(cur_depth: torch.Tensor, step: torch.Tensor, m: int,
                      ref_cam: torch.Tensor,
                      y_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cur_depth (B, h, w), rows [y_offset, y_offset + h) of a depth map →
    (pts (B, G·N, 3) g-major, hyp_depth (B, G, N)), G = 2m+1 hypotheses
    ``step`` apart along the reference viewing ray."""
    b, h, w = cur_depth.shape
    g = 2 * m + 1
    n = h * w
    offsets = torch.arange(g, dtype=cur_depth.dtype, device=cur_depth.device) - m
    hyp_depth = cur_depth.reshape(b, 1, n) + offsets[None, :, None] * step[:, None, None]
    pix = pixel_grid(h, w, device=cur_depth.device)
    pix = pix + torch.tensor([0.0, y_offset, 0.0], device=pix.device)
    pts = unproject_pixels(pix[None, None], hyp_depth,
                           cam_extrinsics(ref_cam)[:, None],
                           cam_intrinsics(ref_cam)[:, None])      # (B, G, N, 3)
    return pts.reshape(b, g * n, 3), hyp_depth


class PointFlow(nn.Module):
    """One PointFlow refinement of a depth map or of a row band of one (the
    JAX package's ``PointFlowCore``): hypothesis points → multi-view
    variance features → windowed kNN → EdgeConvs → per-hypothesis
    probabilities → expected residual. Weights are shared across the flow
    iterations and the bands."""

    def __init__(self, in_channels: int, edge_channels: Sequence[int] = (32, 32, 64),
                 flow_channels: Sequence[int] = (64, 64, 16, 1), m: int = 2,
                 k: int = 16, window: int = 5, norm: str = "bn",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        chans = [in_channels, *edge_channels]
        self.edge_convs = nn.ModuleList(
            EdgeConv(chans[i], chans[i + 1], norm, dtype=dtype)
            for i in range(len(edge_channels)))
        self.head = SharedMLP(sum(edge_channels), flow_channels, norm,
                              last_relu=False, last_norm=False, dtype=dtype)
        self.m, self.k, self.window = m, k, window

    def forward(self, levels: List[torch.Tensor], cams_levels: List[torch.Tensor],
                ref_cam: torch.Tensor, cur_depth: torch.Tensor,
                step: torch.Tensor, y_offset: int = 0, full_h: int = 0) -> torch.Tensor:
        """levels [(B, V, h_l, w_l, C_l)] channels-last; cams_levels
        [(B, V, 2, 4, 4)] at each level's resolution; ref_cam (B, 2, 4, 4)
        at the flow resolution; cur_depth (B, h, w), rows [y_offset,
        y_offset + h) of the flow map of height ``full_h`` (default h);
        step (B,) → refined depth (B, h, w)."""
        b, h, w = cur_depth.shape
        g = 2 * self.m + 1
        n = h * w
        full_h = full_h or h
        with profiler.span("point_flow.fetch"):
            x, hyp_depth = hypothesis_points(cur_depth, step, self.m, ref_cam, y_offset)

            # the reference view projects every hypothesis back onto its
            # scaled pixel grid: one regular-grid resample shared by the G
            # hypotheses (masked where the depth is non-positive); only the
            # V−1 source views need point gathers
            nv = levels[0].shape[1]
            ref_valid = (hyp_depth > 0).reshape(b, g, n)[..., None]
            ref_parts = []
            for fmap in levels:
                rh, rw = fmap.shape[2], fmap.shape[3]
                ref_s = regular_grid_sample(fmap[:, 0], rw / w, rh / full_h, h, w, y_offset)
                ref_parts.append(torch.where(ref_valid, ref_s[:, None], 0.0)
                                 .reshape(b, g * n, -1))
            ref_all = torch.cat(ref_parts, dim=-1)              # (B, G·N, ΣC)
            s1, s2 = fetch_features_perlevel([f[:, 1:] for f in levels], x,
                                             cams_levels[0][:, 1:])
            mean = (ref_all + s1) / nv
            sq_mean = (ref_all.square() + s2) / nv
            point_feat = sq_mean - mean.square()

        with profiler.span("point_flow.knn"):
            pts = x.detach().float().contiguous()
            if self.training:
                idx, mask = window_knn_idx(pts, (g, h, w), self.k, self.window), None
            else:
                idx, mask = window_knn_mask(pts, (g, h, w), self.k, self.window)
        with profiler.span("point_flow.edge_conv"):
            edge_outs = []
            y = point_feat
            for ec in self.edge_convs:
                y = ec(y, idx, mask=mask, grid_shape=(g, h, w), window=self.window)
                edge_outs.append(y)
        with profiler.span("point_flow.head"):
            logits = self.head(torch.cat(edge_outs, dim=-1))    # (B, G·N, 1)
            prob = torch.softmax(logits.reshape(b, g, n), dim=1)
            offsets = torch.arange(g, dtype=cur_depth.dtype, device=cur_depth.device) - self.m
            residual = torch.einsum("bgn,g->bn", prob.float(), offsets) * step[:, None]
            return cur_depth + residual.reshape(b, h, w)


def banded_point_flow(flow: PointFlow, levels: List[torch.Tensor],
                      cams_levels: List[torch.Tensor], ref_cam: torch.Tensor,
                      cur_depth: torch.Tensor, step: torch.Tensor, chunk_rows: int,
                      band_group=None) -> torch.Tensor:
    """``flow`` over ``cur_depth`` (B, h, w) in row bands of ``chunk_rows``
    rows (the JAX package's ``PointFlow.__call__``): each band is refined
    with HALO rows above and below, clamped into the map so that every
    band has the same height cr + 2·HALO, and its own cr rows are kept.
    The halo covers the reach of the three EdgeConvs and the kNN window,
    so under eval BatchNorm the result equals the unbanded pass;
    GroupNorm's statistics over a band's points move it (~1e-2). In
    training the bands are refined one after another, each BatchNorm takes
    that band's batch statistics (over every rank's batch under data
    parallelism) and blends its running statistics once per band, in band
    order, as flax's mutable ``batch_stats`` do over repeated calls; the
    loss reaches a band through its kept rows alone. Unbanded for
    ``chunk_rows`` ≤ 0 or where the map is too short to band
    (h ≤ cr + 2·HALO).

    ``band_group`` (eval only; training raises, as the JAX package trains
    on no band mesh): rank r of the group's n ranks refines bands
    [r·⌈P/n⌉, (r+1)·⌈P/n⌉) of the P bands (what the JAX package's band
    sharding gives each device, padded where n does not divide P), and
    the kept rows of all ranks are gathered in band order."""
    b, h, w = cur_depth.shape
    cr = chunk_rows
    if flow.training and band_group is not None:
        raise ValueError("band-parallel flow is eval-only: train with no band group")
    if cr <= 0 or h <= cr + 2 * HALO:
        return flow(levels, cams_levels, ref_cam, cur_depth, step)
    if h % cr or cr % 8:
        raise ValueError(f"FLOW_CHUNK_ROWS={cr} must divide the flow height {h} and be a "
                         f"multiple of 8")
    bs = cr + 2 * HALO
    y0s = list(range(0, h, cr))
    bands = range(len(y0s))
    if band_group is not None:
        per = -(-len(y0s) // dist.get_world_size(band_group))
        first = dist.get_rank(band_group) * per
        bands = range(min(first, len(y0s)), min(first + per, len(y0s)))
    outs = []
    for i in bands:
        lo = min(max(0, y0s[i] - HALO), h - bs)
        band = flow(levels, cams_levels, ref_cam, cur_depth[:, lo:lo + bs], step, lo, h)
        outs.append(band[:, y0s[i] - lo:y0s[i] - lo + cr])
    if band_group is None:
        return torch.cat(outs, dim=1)
    mine = torch.zeros(per, b, cr, w, dtype=cur_depth.dtype, device=cur_depth.device)
    for j, out in enumerate(outs):
        mine[j] = out
    every = distributed.all_gather_cat(mine, band_group)[:len(y0s)]   # (P, B, cr, w)
    return every.permute(1, 0, 2, 3).reshape(b, h, w)


class PointMVSNet(nn.Module):
    """The full model. ``forward`` takes images (B, V, H, W, 3)
    normalized and cams (B, V, 2, 4, 4) at image resolution, view 0 the
    reference, and returns the JAX package's prediction dict."""

    def __init__(self, img_base_channels: int = 8, vol_base_channels: int = 8,
                 edge_channels: Sequence[int] = (32, 32, 64),
                 flow_channels: Sequence[int] = (64, 64, 16, 1),
                 flow_m: int = 2, knn: int = 16, knn_window: int = 5,
                 norm: str = "bn", coarse_img_scale: float = 0.5,
                 dtype: torch.dtype = torch.float32, flow_chunk_rows: int = 0,
                 band_group=None, view_group=None):
        """``band_group`` / ``view_group``: process groups (``EvalGrid``)
        that share out the flow bands of one map and the cost volume's
        views, or None."""
        super().__init__()
        c = img_base_channels
        self.img_conv = ImageConv(c, norm, dtype)
        self.vol_conv = VolumeConv(vol_base_channels, 4 * c, norm, dtype)
        self.point_flow = PointFlow(7 * c, edge_channels, flow_channels, flow_m,
                                    knn, knn_window, norm, dtype)
        self.coarse_img_scale = coarse_img_scale
        self.dtype = dtype
        self.flow_chunk_rows = flow_chunk_rows
        self.band_group, self.view_group = band_group, view_group

    def _pyramid(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The shared 2-D CNN over all views folded into the batch."""
        b, v = images.shape[:2]
        out = self.img_conv(images.reshape(b * v, *images.shape[2:]))
        return {k: f.reshape(b, v, *f.shape[1:]) for k, f in out.items()}

    def forward(self, images: torch.Tensor, cams: torch.Tensor,
                is_flow: bool = True,
                img_scales: Sequence[float] = (0.25, 0.5),
                inter_scales: Sequence[float] = (0.75, 0.375),
                num_virtual_plane: int = 48) -> Dict[str, torch.Tensor]:
        b, v, height, width, _ = images.shape
        if height % 64 or width % 64:
            raise ValueError(
                f"input {height}x{width} must be divisible by 64 (coarse "
                f"stage 1/8 + 3-level volume U-Net); crop_mvs_input(base=64) "
                f"produces compliant shapes")
        if num_virtual_plane % 8:
            raise ValueError(f"num_virtual_plane={num_virtual_plane} must be "
                             f"divisible by 8 (volume U-Net strides)")
        # ---------------- coarse stage -----------------------------------
        with profiler.span("model.coarse"):
            images = images.to(self.dtype)
            cams = cams.float()
            ch = int(height * self.coarse_img_scale)
            cw = int(width * self.coarse_img_scale)
            # kept: an eval flow iteration at the coarse scale reuses it (in
            # training every run of ImageConv blends its own BN statistics)
            coarse_pyr = self._pyramid(_resize_views(images, ch, cw))
            feats = coarse_pyr["conv2"]                          # (B, V, fh, fw, C)
            fh, fw = feats.shape[2], feats.shape[3]
            cams_feat = scale_cams(cams, fw / width, fh / height)
            d_min, d_int, _, _ = cam_depth_range(cams[:, 0])
            depths = depth_hypotheses(d_min, d_int, num_virtual_plane)
            if self.view_group is not None:
                cost = view_sharded_plane_sweep(feats, cams_feat, cams_feat[:, 0], depths,
                                                self.view_group)
            else:
                cost = plane_sweep_volume(feats, cams_feat, depths)
            logits = self.vol_conv(cost)[..., 0]                 # (B, D, fh, fw)
            prob = torch.softmax(logits.float(), dim=1)
            cur = depth_regression(prob, depths)
            preds: Dict[str, torch.Tensor] = {
                "coarse_depth_map": cur,
                "coarse_prob_map": photometric_confidence(prob),
            }
        if not is_flow:
            return preds

        # ---------------- PointFlow iterations ---------------------------
        for it, (s, inter_s) in enumerate(zip(img_scales, inter_scales)):
            with profiler.span(f"model.flow{it + 1}"):
                th, tw = int(height * s), int(width * s)
                if not self.training and (th, tw) == (ch, cw):
                    pyr = coarse_pyr
                else:
                    pyr = self._pyramid(_resize_views(images, th, tw))
                levels = [pyr["conv0"], pyr["conv1"], pyr["conv2"]]
                cams_levels = [scale_cams(cams, lvl.shape[3] / width, lvl.shape[2] / height)
                               for lvl in levels]
                ref_cam = scale_cams(cams[:, 0], tw / width, th / height)
                cur = resize_bilinear(cur, th, tw)
                preds[f"flow{it + 1}_input"] = cur.detach()
                cur = banded_point_flow(self.point_flow, levels, cams_levels, ref_cam, cur,
                                        d_int * inter_s, self.flow_chunk_rows, self.band_group)
                preds[f"flow{it + 1}"] = cur
        return preds
