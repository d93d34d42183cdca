"""Plain PyTorch reference of Point-MVSNet (Chen et al., ICCV 2019,
arXiv:1908.04422) for the benchmark's correctness check and its operation
counts.

A frozen copy of the measured program's plain path, cut down to one
device and to what the cells run: no row bands, no process groups, no
CUDA kernels. The windowed kNN is the plain key sort (ties ordered as the
program's plain kNN orders them) and EdgeConv's eval path is the plain
masked window max. It imports nothing of the measured program; state_dict
keys are the program's, so one set of weights loads into both.

Layouts: images (B, V, H, W, 3) normalized, cams (B, V, 2, 4, 4) with
cam[0] the world→camera extrinsic, cam[1, :3, :3] = K and cam[1, 3] =
[d_min, d_interval, d_num, d_max]; view 0 is the reference view.

``Precision`` says how each operand of a convolution or matmul is held:
"f32" (as is), "bf16" (cast to bfloat16, as the program's bf16 config),
"tf32" (rounded to TF32's 10-bit mantissa, computed in f32: what the
tensor cores do with TF32 inputs) or "fp8" (e4m3 with a per-tensor scale
from the operand's largest magnitude, computed in f32); the gradient of a
rounded operand passes straight through. f32 is the reference; tf32 and
fp8 are the controls one precision below the f32 and bf16 configs.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0                              # largest finite float8_e4m3fn
_NEG = torch.finfo(torch.float32).min / 2   # masked max where no candidate is set
_INT_OF_SIZE = {2: torch.int16, 4: torch.int32, 8: torch.int64}
BN_MOMENTUM = 0.9
PRECISION_OF = {"bfloat16": "bf16", "float32": "f32"}     # a config's dtype → Precision


class Precision:
    """Operand format of every convolution and matmul: "f32", "bf16",
    "tf32" or "fp8". ``dtype`` is what activations are stored in between
    layers (bf16 for "bf16", else f32)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "bf16", "tf32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.bfloat16 if name == "bf16" else torch.float32

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "bf16":
            return x.to(torch.bfloat16)
        x = x.float()
        if self.name == "tf32":
            bits = x.detach().contiguous().view(torch.int32)
            bits = bits + 0x0FFF + ((bits >> 13) & 1)     # round to nearest even
            low = (bits & ~0x1FFF).view(torch.float32)
        elif self.name == "fp8":
            scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-30)
            low = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        else:
            return x
        return x + (low - x.detach())       # the rounded value; the gradient passes through


# ---------------------------------------------------------------- geometry

def cam_extrinsics(cams):
    return cams[..., 0, :, :]


def cam_intrinsics(cams):
    return cams[..., 1, :3, :3]


def cam_depth_range(cams):
    row = cams[..., 1, 3, :]
    return row[..., 0], row[..., 1], row[..., 2], row[..., 3]


def pixel_grid(height: int, width: int, device=None) -> torch.Tensor:
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=device),
                          torch.arange(width, dtype=torch.float32, device=device),
                          indexing="ij")
    return torch.stack([u, v, torch.ones_like(u)], dim=-1).reshape(height * width, 3)


def depth_hypotheses(depth_min, depth_interval, num_depth: int):
    j = torch.arange(num_depth, dtype=torch.float32, device=depth_min.device)
    return depth_min[..., None] + j * depth_interval[..., None]


def intrinsic_inverse(k: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of a pinhole K."""
    fx, s, cx = k[..., 0, 0], k[..., 0, 1], k[..., 0, 2]
    fy, cy = k[..., 1, 1], k[..., 1, 2]
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    ifx, ify = 1.0 / fx, 1.0 / fy
    row0 = torch.stack([ifx, -s * ifx * ify, (s * cy - cx * fy) * ifx * ify], dim=-1)
    row1 = torch.stack([zero, ify, -cy * ify], dim=-1)
    row2 = torch.stack([zero, zero, one], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def unproject_pixels(pixels_h, depth, extrinsic, intrinsic):
    cam_pts = torch.einsum("...ij,...nj->...ni", intrinsic_inverse(intrinsic),
                           pixels_h) * depth[..., None]
    r, t = extrinsic[..., :3, :3], extrinsic[..., :3, 3]
    return torch.einsum("...ji,...nj->...ni", r, cam_pts - t[..., None, :])


def project_points(points, extrinsic, intrinsic):
    r, t = extrinsic[..., :3, :3], extrinsic[..., :3, 3]
    cam_pts = torch.einsum("...ij,...nj->...ni", r, points) + t[..., None, :]
    proj = torch.einsum("...ij,...nj->...ni", intrinsic, cam_pts)
    z = proj[..., 2]
    safe_z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    return proj[..., :2] / safe_z[..., None], z


def scale_cams(cams, sx: float, sy: float):
    out = cams.clone()
    out[..., 1, 0, :3] *= sx
    out[..., 1, 1, :3] *= sy
    return out


# ---------------------------------------------------------------- sampling

def bilinear_sample(feat, uv, valid=None):
    """feat (..., H, W, C) at pixel coords uv (..., N, 2), zero outside
    (``grid_sample(align_corners=True, padding_mode="zeros")``) → f32."""
    lead = feat.shape[:-3]
    h, w, c = feat.shape[-3:]
    nb = 1
    for d in lead:
        nb *= d
    flat = feat.reshape(nb * h * w, c)
    u, v = uv[..., 0].reshape(nb, -1), uv[..., 1].reshape(nb, -1)
    n = u.shape[-1]
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = (u - u0)[..., None], (v - v0)[..., None]
    i0, j0 = u0.long(), v0.long()
    base = (torch.arange(nb, device=feat.device) * (h * w))[:, None]

    def tap(i, j):
        inside = ((i >= 0) & (i <= w - 1) & (j >= 0) & (j <= h - 1))[..., None]
        idx = base + j.clamp(0, h - 1) * w + i.clamp(0, w - 1)
        rows = flat.index_select(0, idx.reshape(-1)).reshape(nb, n, c)
        return torch.where(inside, rows, 0)

    out = (tap(i0, j0) * ((1 - du) * (1 - dv)) + tap(i0 + 1, j0) * (du * (1 - dv))
           + tap(i0, j0 + 1) * ((1 - du) * dv) + tap(i0 + 1, j0 + 1) * (du * dv))
    if valid is not None:
        out = torch.where(valid.reshape(nb, n, 1), out, 0)
    return out.reshape(*lead, n, c)


def regular_grid_sample(feat, sx: float, sy: float, out_h: int, out_w: int):
    """feat (B, H, W, C) at u = j·sx, v = i·sy, as two interpolation
    matmuls → (B, out_h·out_w, C) f32."""
    b, h, w, c = feat.shape

    def interp(n_out, scale, n_in):
        t = torch.arange(n_out, dtype=torch.float32, device=feat.device) * scale
        t0 = torch.floor(t)
        dt = (t - t0)[:, None]
        i0 = t0.long()[:, None]
        cols = torch.arange(n_in, device=feat.device)[None, :]
        return (torch.where((cols == i0) & (i0 >= 0) & (i0 <= n_in - 1), 1.0 - dt, 0.0)
                + torch.where((cols == i0 + 1) & (i0 + 1 >= 0) & (i0 + 1 <= n_in - 1),
                              dt, 0.0))

    y = torch.einsum("bhwc,ow->bhoc", feat.float(), interp(out_w, sx, w))
    y = torch.einsum("bhoc,ph->bpoc", y, interp(out_h, sy, h))
    return y.reshape(b, out_h * out_w, c)


def resize_bilinear(x, out_h: int, out_w: int):
    """(B, H, W) → (B, out_h, out_w), half-pixel centres, edges clamped."""
    _, h, w = x.shape

    def lerp(n_out, n_in):
        t = ((torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5)
             * (n_in / n_out) - 0.5).clamp_min(0.0)
        i0 = t.long()
        lam = (t - i0)[:, None]
        i1 = (i0 + 1).clamp_max(n_in - 1)[:, None]
        cols = torch.arange(n_in, device=x.device)[None, :]
        return (torch.where(cols == i0[:, None], 1.0 - lam, 0.0)
                + torch.where(cols == i1, lam, 0.0))

    y = torch.einsum("bhw,ow->bho", x.float(), lerp(out_w, w))
    return torch.einsum("bho,ph->bpo", y, lerp(out_h, h))


def _project(points, cams):
    cams = cams.float()
    return project_points(points.float()[:, None], cam_extrinsics(cams), cam_intrinsics(cams))


def fetch_features(feats, points, cams):
    uv, z = _project(points, cams)
    return bilinear_sample(feats, uv, valid=z > 0)


def fetch_features_perlevel(levels, points, cams):
    """View-reduced f32 moments (Σ_v f, Σ_v f²) of a per-level bilinear fetch."""
    uv, z = _project(points, cams)
    valid = z > 0
    s1 = s2 = None
    for vi in range(levels[0].shape[1]):
        f_v = torch.cat([bilinear_sample(f[:, vi], uv[:, vi] * (1.0 / (1 << l)),
                                         valid=valid[:, vi])
                         for l, f in enumerate(levels)], dim=-1)
        s1 = f_v if s1 is None else s1 + f_v
        s2 = f_v.square() if s2 is None else s2 + f_v.square()
    return s1, s2


# ------------------------------------------------------------- cost volume

def plane_sweep_volume(feats, cams, depths):
    b, v, h, w, c = feats.shape
    d = depths.shape[-1]
    cams = cams.float()
    grid = pixel_grid(h, w, device=feats.device)
    pts = unproject_pixels(grid[None, None], depths.float()[..., None],
                           cam_extrinsics(cams)[:, 0, None], cam_intrinsics(cams)[:, 0, None])
    pts = pts.reshape(b, d * h * w, 3)
    ref_f = feats[:, 0].float().reshape(b, 1, h * w, c)
    ref_f = torch.where((depths > 0)[..., None, None], ref_f, 0.0).reshape(b, d * h * w, c)
    src = fetch_features(feats[:, 1:], pts, cams[:, 1:])
    mean = (ref_f + src.sum(dim=1)) / v
    sq_mean = (ref_f.square() + src.square().sum(dim=1)) / v
    return (sq_mean - mean.square()).reshape(b, d, h, w, c)


def photometric_confidence(prob):
    """Probability mass of the 4 hypotheses around the argmax."""
    pad = F.pad(prob, (0, 0, 0, 0, 1, 2))
    csum = F.pad(torch.cumsum(pad, dim=1), (0, 0, 0, 0, 1, 0))
    win4 = csum[:, 4:] - csum[:, :-4]
    return torch.gather(win4, 1, prob.argmax(dim=1, keepdim=True))[:, 0]


# --------------------------------------------------------------------- kNN

def _int32_bits(v):
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def window_knn(points, grid_shape, k: int, window: int, with_mask: bool = False):
    """points (B, G·H·W, 3) f32 → idx (B, P, k) int32, nearest first, and
    with ``with_mask`` the (B, NW, G, H, W) selection bitplanes. Candidates
    ranked by the packed key (d² with its low 7 bits replaced by the
    candidate id)."""
    g, h, w = grid_shape
    b = points.shape[0]
    r = window // 2
    dev = points.device
    pts = points.reshape(b, g, h, w, 3)
    q = pts.unbind(-1)
    padded = F.pad(pts.permute(0, 1, 4, 2, 3), (r, r, r, r), value=1e15)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    keys = []
    for gc in range(g):
        for dy in range(window):
            for dx in range(window):
                c = padded[:, gc, :, dy:dy + h, dx:dx + w]
                e = [q[i] - c[:, None, i] for i in range(3)]
                d2 = (e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]
                inside = ((ys + dy - r >= 0) & (ys + dy - r < h)
                          & (xs + dx - r >= 0) & (xs + dx - r < w))
                d2 = torch.where(inside, d2, 1e30)
                cid = (gc * window + dy) * window + dx
                keys.append((d2.view(torch.int32) & ~0x7F) | cid)
    key = torch.stack(keys, dim=-1)
    del keys
    nn_ = torch.topk(key, k, dim=-1, largest=False, sorted=True).indices
    del key
    gc = nn_ // (window * window)
    s = nn_ % (window * window)
    yc = ys[..., None] + s // window - r
    xc = xs[..., None] + s % window - r
    idx = (gc * (h * w) + yc * w + xc).to(torch.int32).reshape(b, g * h * w, k)
    if not with_mask:
        return idx
    nw = -(-(g * window * window) // 32)
    bit = torch.ones((), dtype=torch.int64, device=dev) << (nn_ % 32)
    planes = [_int32_bits(torch.where(nn_ // 32 == wi, bit, 0).sum(-1)) for wi in range(nw)]
    return idx, torch.stack(planes, dim=1)


def gather_knn(features, indices):
    b, p, c = features.shape
    _, n, k = indices.shape
    offs = (torch.arange(b, device=features.device) * p)[:, None, None]
    flat = (indices.long() + offs).reshape(-1)
    return features.reshape(b * p, c).index_select(0, flat).reshape(b, n, k, c)


def maximum_ieee(a, b):
    """``jnp.maximum``: NaN wins, +0 over −0."""
    it = _INT_OF_SIZE[a.element_size()]
    m = torch.maximum(a, b).view(it)
    return (m & ~((a.view(it) ^ b.view(it)) & torch.iinfo(it).min)).view(a.dtype)


def masked_window_max(z, mask, grid_shape, window: int):
    """out[b, p, f] = max of z over the window candidates set in p's mask."""
    g, h, w = grid_shape
    b, p, f = z.shape
    r = window // 2
    padded = F.pad(z.reshape(b, g, h, w, f), (0, 0, r, r, r, r), value=_NEG)
    acc = torch.full((b, g, h, w, f), _NEG, dtype=z.dtype, device=z.device)
    for gc in range(g):
        for dy in range(window):
            for dx in range(window):
                s = (gc * window + dy) * window + dx
                sel = ((mask[:, s // 32] >> (s % 32)) & 1).bool()[..., None]
                cand = padded[:, gc, dy:dy + h, dx:dx + w][:, None]
                acc = torch.where(sel, maximum_ieee(acc, cand), acc)
    return acc.reshape(b, p, f)


# ------------------------------------------------------------------ blocks

def bn_batch_stats(bn, x, dims):
    """flax's train-mode BatchNorm: f32 batch mean and E[x²] − E[x]²."""
    xf = x.float()
    ch = next(d for d in range(x.dim()) if d not in dims)
    c = xf.shape[ch]
    count = x.numel() // c
    mean = xf.sum(dims) / count
    var = (xf.square().sum(dims) / count - mean.square()).clamp_min(0.0)
    shape = [1] * x.dim()
    shape[ch] = -1
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (xf - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape), mean, var


@torch.no_grad()
def bn_blend(bn, mean, var):
    keep = 0.0 if getattr(bn, "calibrating", False) else BN_MOMENTUM
    bn.running_mean.copy_(keep * bn.running_mean + (1.0 - keep) * mean)
    bn.running_var.copy_(keep * bn.running_var + (1.0 - keep) * var)


def apply_bn(bn, x):
    """Channels at dim 1. Training: batch statistics, f32 out, running
    statistics blended; eval: running statistics, x's dtype out."""
    if bn is None:
        return x
    if bn.training:
        y, mean, var = bn_batch_stats(bn, x, [0, *range(2, x.dim())])
        bn_blend(bn, mean, var)
        return y
    return bn(x)


_BN = {1: nn.BatchNorm1d, 2: nn.BatchNorm2d, 3: nn.BatchNorm3d}


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, k, stride, prec, norm=True, relu=True, rank=2):
        super().__init__()
        self.conv = {2: nn.Conv2d, 3: nn.Conv3d}[rank](cin, cout, k, stride,
                                                       padding=k // 2, bias=not norm)
        self.norm = _BN[rank](cout, eps=1e-5) if norm else None
        self.relu, self.prec = relu, prec
        self._fn = {2: F.conv2d, 3: F.conv3d}[rank]

    def forward(self, x):
        c, p = self.conv, self.prec
        bias = None if c.bias is None else c.bias.to(p.dtype)
        x = apply_bn(self.norm, self._fn(p(x), p(c.weight), bias, c.stride, c.padding))
        return F.relu(x) if self.relu else x


class DeconvBlock(nn.Module):
    def __init__(self, cin, cout, prec):
        super().__init__()
        self.conv = nn.ConvTranspose3d(cin, cout, 3, 2, padding=1, output_padding=1,
                                       bias=False)
        self.norm = nn.BatchNorm3d(cout, eps=1e-5)
        self.prec = prec

    def forward(self, x):
        c, p = self.conv, self.prec
        x = F.conv_transpose3d(p(x), p(c.weight), None, c.stride, c.padding,
                               c.output_padding)
        return F.relu(apply_bn(self.norm, x))


class _Dense(nn.Module):
    def __init__(self, cin, cout, norm):
        super().__init__()
        self.linear = nn.Linear(cin, cout, bias=not norm)
        self.norm = nn.BatchNorm1d(cout, eps=1e-5) if norm else None


class SharedMLP(nn.Module):
    """Per-point MLP over (B, N, C); the last layer has no norm or relu."""

    def __init__(self, cin, features, prec):
        super().__init__()
        chans = [cin, *features]
        n = len(features)
        self.layers = nn.ModuleList(_Dense(chans[i], chans[i + 1], i < n - 1)
                                    for i in range(n))
        self.prec = prec

    def forward(self, x):
        p, n = self.prec, len(self.layers)
        for i, layer in enumerate(self.layers):
            lin = layer.linear
            bias = None if lin.bias is None else lin.bias.to(p.dtype)
            x = F.linear(p(x), p(lin.weight), bias)
            if layer.norm is not None:
                x = apply_bn(layer.norm, x.transpose(1, 2)).transpose(1, 2)
            if i < n - 1:
                x = F.relu(x)
        return x


_IMG_LAYOUT = [(1, 3, 1), (1, 3, 1), (2, 5, 2), (2, 3, 1), (2, 3, 1), (4, 5, 2),
               (4, 3, 1), (4, 3, 1), (8, 5, 2), (8, 3, 1), (8, 3, 1)]
_TAPS = {1: "conv0", 4: "conv1", 7: "conv2", 10: "conv3"}


class ImageConv(nn.Module):
    def __init__(self, c, prec):
        super().__init__()
        blocks, cin = [], 3
        for mult, k, s in _IMG_LAYOUT:
            blocks.append(ConvBlock(cin, mult * c, k, s, prec))
            cin = mult * c
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        out = {}
        x = x.permute(0, 3, 1, 2)
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in _TAPS:
                out[_TAPS[i]] = x.permute(0, 2, 3, 1)
        return out


class VolumeConv(nn.Module):
    def __init__(self, c, cin, prec):
        super().__init__()
        kw = dict(prec=prec, rank=3)
        self.convs = nn.ModuleList([
            ConvBlock(cin, c, 3, 1, **kw),
            ConvBlock(c, 2 * c, 3, 2, **kw), ConvBlock(2 * c, 2 * c, 3, 1, **kw),
            ConvBlock(2 * c, 4 * c, 3, 2, **kw), ConvBlock(4 * c, 4 * c, 3, 1, **kw),
            ConvBlock(4 * c, 8 * c, 3, 2, **kw), ConvBlock(8 * c, 8 * c, 3, 1, **kw),
            ConvBlock(c, 1, 3, 1, norm=False, relu=False, **kw)])
        self.deconvs = nn.ModuleList([DeconvBlock(8 * c, 4 * c, prec),
                                      DeconvBlock(4 * c, 2 * c, prec),
                                      DeconvBlock(2 * c, c, prec)])

    def forward(self, x):
        cv = self.convs
        c0 = cv[0](x.permute(0, 4, 1, 2, 3))
        c1 = cv[2](cv[1](c0))
        c2 = cv[4](cv[3](c1))
        c3 = cv[6](cv[5](c2))
        u2 = self.deconvs[0](c3) + c2
        u1 = self.deconvs[1](u2) + c1
        u0 = self.deconvs[2](u1) + c0
        return cv[7](u0).permute(0, 2, 3, 4, 1)


class EdgeConv(nn.Module):
    """x (B, N, C) → (B, N, F): relu(BN(W·[x_i, x_j − x_i])) maxed over the
    k neighbours j, as W_n·x_j + (W_c − W_n)·x_i. Eval with a mask: BN's
    affine folded in front of the plain masked window max; training: the
    (B, N, K, F) gather, recomputed in the backward (it does not fit the
    card three times over at the training config)."""

    def __init__(self, cin, features, prec):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(2 * cin, features))
        self.norm = nn.BatchNorm1d(features, eps=1e-5)
        self.prec = prec

    def forward(self, x, idx, mask, grid_shape, window):
        p = self.prec
        c = x.shape[-1]
        kernel = p(self.kernel)
        x = p(x)
        z = x @ kernel[c:]
        cterm = x @ p(kernel[:c] - kernel[c:])
        if not self.training:
            bn, dt = self.norm, p.dtype
            mul = torch.rsqrt(bn.running_var.to(dt) + bn.eps) * bn.weight.to(dt)
            z2 = z * mul
            c2 = (cterm - bn.running_mean.to(dt)) * mul + bn.bias.to(dt)
            return F.relu(masked_window_max(z2.contiguous(), mask, grid_shape, window) + c2)
        if torch.is_grad_enabled():
            out, mean, var = checkpoint(self._gather_max, z, cterm, idx, use_reentrant=False)
        else:
            out, mean, var = self._gather_max(z, cterm, idx)
        bn_blend(self.norm, mean, var)
        return out

    def _gather_max(self, z, cterm, idx):
        pre = gather_knn(z, idx) + cterm[:, :, None, :]
        y, mean, var = bn_batch_stats(self.norm, pre, [0, 1, 2])
        return F.relu(y.to(pre.dtype)).amax(dim=2), mean.detach(), var.detach()


def hypothesis_points(cur_depth, step, m: int, ref_cam):
    b, h, w = cur_depth.shape
    g, n = 2 * m + 1, h * w
    offsets = torch.arange(g, dtype=cur_depth.dtype, device=cur_depth.device) - m
    hyp = cur_depth.reshape(b, 1, n) + offsets[None, :, None] * step[:, None, None]
    pix = pixel_grid(h, w, device=cur_depth.device)
    pts = unproject_pixels(pix[None, None], hyp, cam_extrinsics(ref_cam)[:, None],
                           cam_intrinsics(ref_cam)[:, None])
    return pts.reshape(b, g * n, 3), hyp


Observer = Optional[Callable[[Tuple[int, int, int], torch.Tensor], None]]


class PointFlow(nn.Module):
    def __init__(self, cin, edge_channels, flow_channels, m, k, window, prec):
        super().__init__()
        chans = [cin, *edge_channels]
        self.edge_convs = nn.ModuleList(EdgeConv(chans[i], chans[i + 1], prec)
                                        for i in range(len(edge_channels)))
        self.head = SharedMLP(sum(edge_channels), flow_channels, prec)
        self.m, self.k, self.window = m, k, window

    def forward(self, levels, cams_levels, ref_cam, cur_depth, step, observe: Observer = None):
        b, h, w = cur_depth.shape
        g, n = 2 * self.m + 1, h * w
        offsets = torch.arange(g, dtype=cur_depth.dtype, device=cur_depth.device) - self.m
        x, hyp = hypothesis_points(cur_depth, step, self.m, ref_cam)
        nv = levels[0].shape[1]
        ref_valid = (hyp > 0).reshape(b, g, n)[..., None]
        ref_parts = []
        for fmap in levels:
            rh, rw = fmap.shape[2], fmap.shape[3]
            ref_s = regular_grid_sample(fmap[:, 0], rw / w, rh / h, h, w)
            ref_parts.append(torch.where(ref_valid, ref_s[:, None], 0.0).reshape(b, g * n, -1))
        ref_all = torch.cat(ref_parts, dim=-1)
        s1, s2 = fetch_features_perlevel([f[:, 1:] for f in levels], x, cams_levels[0][:, 1:])
        mean = (ref_all + s1) / nv
        point_feat = (ref_all.square() + s2) / nv - mean.square()
        del ref_all, s1, s2, mean
        pts = x.detach().float().contiguous()
        grid = (g, h, w)
        if self.training:
            idx, mask = window_knn(pts, grid, self.k, self.window), None
        else:
            idx, mask = window_knn(pts, grid, self.k, self.window, with_mask=True)
            if observe is not None:
                observe(grid, mask)
        outs, y = [], point_feat
        for ec in self.edge_convs:
            y = ec(y, idx, mask, grid, self.window)
            outs.append(y)
        logits = self.head(torch.cat(outs, dim=-1))
        prob = torch.softmax(logits.reshape(b, g, n), dim=1)
        residual = torch.einsum("bgn,g->bn", prob.float(), offsets) * step[:, None]
        return cur_depth + residual.reshape(b, h, w)


def _resize_views(images, h, w, prec):
    b, v, hh, ww, c = images.shape
    x = images.reshape(b * v, hh, ww, c).permute(0, 3, 1, 2).float()
    x = F.interpolate(x, (h, w), mode="bilinear", align_corners=False, antialias=True)
    return prec(x.permute(0, 2, 3, 1).reshape(b, v, h, w, c))


class PointMVSNet(nn.Module):
    """Coarse plane sweep + PointFlow iterations → the program's
    prediction dict (coarse_depth_map, coarse_prob_map, flowN_input,
    flowN). ``model.train()`` selects the training forward: batch
    statistics, the kNN's indices alone with EdgeConv's gather, the image
    pyramid run anew for every flow iteration."""

    def __init__(self, img_base_channels=8, vol_base_channels=8, edge_channels=(32, 32, 64),
                 flow_channels=(64, 64, 16, 1), flow_m=2, knn=16, knn_window=5,
                 precision: str = "f32"):
        super().__init__()
        self.prec = Precision(precision)
        c = img_base_channels
        self.img_conv = ImageConv(c, self.prec)
        self.vol_conv = VolumeConv(vol_base_channels, 4 * c, self.prec)
        self.point_flow = PointFlow(7 * c, edge_channels, flow_channels, flow_m, knn,
                                    knn_window, self.prec)

    def _pyramid(self, images):
        b, v = images.shape[:2]
        out = self.img_conv(images.reshape(b * v, *images.shape[2:]))
        return {k: f.reshape(b, v, *f.shape[1:]) for k, f in out.items()}

    def forward(self, images, cams, is_flow=True, img_scales: Sequence[float] = (0.25, 0.5),
                inter_scales: Sequence[float] = (0.75, 0.375), num_virtual_plane: int = 48,
                observe: Observer = None,
                flow_inputs: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """``observe(grid, mask)``: called with each eval flow iteration's
        kNN selection mask. ``flow_inputs``: each flow iteration starts from
        the depth given (B, h, w) rather than from the previous stage's, and
        the coarse stage is not run (its maps are left out)."""
        b, v, height, width, _ = images.shape
        images = self.prec(images)
        cams = cams.float()
        ch, cw = height // 2, width // 2
        coarse_pyr = self._pyramid(_resize_views(images, ch, cw, self.prec))
        feats = coarse_pyr["conv2"]
        fh, fw = feats.shape[2], feats.shape[3]
        d_min, d_int, _, _ = cam_depth_range(cams[:, 0])
        if flow_inputs is not None:
            return self._flows(images, cams, coarse_pyr, d_int, img_scales, inter_scales,
                               observe, {}, None, flow_inputs)
        depths = depth_hypotheses(d_min, d_int, num_virtual_plane)
        cost = plane_sweep_volume(feats, scale_cams(cams, fw / width, fh / height), depths)
        logits = self.vol_conv(cost)[..., 0]
        del cost
        prob = torch.softmax(logits.float(), dim=1)
        cur = torch.einsum("bdhw,bd->bhw", prob, depths)
        preds = {"coarse_depth_map": cur, "coarse_prob_map": photometric_confidence(prob)}
        if not is_flow:
            return preds
        return self._flows(images, cams, coarse_pyr, d_int, img_scales, inter_scales, observe,
                           preds, cur)

    def _flows(self, images, cams, coarse_pyr, d_int, img_scales, inter_scales, observe,
               preds, cur, flow_inputs=None):
        height, width = images.shape[2], images.shape[3]
        ch, cw = height // 2, width // 2
        for it, (s, inter_s) in enumerate(zip(img_scales, inter_scales)):
            th, tw = int(height * s), int(width * s)
            if not self.training and (th, tw) == (ch, cw):
                pyr = coarse_pyr
            else:
                pyr = self._pyramid(_resize_views(images, th, tw, self.prec))
            levels = [pyr["conv0"], pyr["conv1"], pyr["conv2"]]
            cams_levels = [scale_cams(cams, lv.shape[3] / width, lv.shape[2] / height)
                           for lv in levels]
            ref_cam = scale_cams(cams[:, 0], tw / width, th / height)
            cur = (resize_bilinear(cur, th, tw) if flow_inputs is None
                   else flow_inputs[it].float())
            preds[f"flow{it + 1}_input"] = cur.detach()
            cur = self.point_flow(levels, cams_levels, ref_cam, cur, d_int * inter_s, observe)
            preds[f"flow{it + 1}"] = cur
        return preds


def build(model_cfg: Dict, precision: str = "f32") -> PointMVSNet:
    """A config file's ``model`` block (the program's MODEL keys) → the
    reference, with uninitialized weights (load a state_dict)."""
    return PointMVSNet(
        img_base_channels=model_cfg["IMG_BASE_CHANNELS"],
        vol_base_channels=model_cfg["VOL_BASE_CHANNELS"],
        edge_channels=tuple(model_cfg["EDGE_CHANNELS"]),
        flow_channels=tuple(model_cfg["FLOW_CHANNELS"]),
        flow_m=model_cfg["FLOW_INTERVAL_M"], knn=model_cfg["KNN"],
        knn_window=model_cfg["KNN_WINDOW"], precision=precision)


@torch.no_grad()
def calibrate_bn(net: PointMVSNet, images, cams, kwargs: Dict) -> None:
    """Set every BatchNorm's running statistics to the batch statistics of
    one training-mode forward over ``images``, as a trained network's are:
    each layer then normalizes what reaches it. Drawn apart from the data,
    they shift every channel by more than it varies, and the signal that
    tells PointFlow's hypotheses apart fades layer by layer."""
    bns = [m for m in net.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    net.train()
    for bn in bns:
        bn.calibrating = True
    try:
        net(images, cams, **kwargs)
    finally:
        for bn in bns:
            del bn.calibrating
        net.eval()


def flow_keys(preds: Dict[str, torch.Tensor]) -> List[str]:
    return sorted(k for k in preds if k.startswith("flow") and not k.endswith("_input"))


def request_inputs(frames, cams, base: int = 64):
    """A request's frames (V, H, W, 3) and cams (V, 2, 4, 4), as numpy →
    the model's (images (1, V, h, w, 3), cams (1, V, 2, 4, 4)) f32 tensors:
    centre crop to multiples of ``base`` with the principal points
    shifted, then per-image, per-channel standardization."""
    import numpy as np
    frames = np.asarray(frames, np.float32)
    cams = np.array(cams, np.float32)
    h, w = frames.shape[1:3]
    nh, nw = h // base * base, w // base * base
    top, left = (h - nh) // 2, (w - nw) // 2
    frames = frames[:, top:top + nh, left:left + nw]
    cams[:, 1, 0, 2] -= left
    cams[:, 1, 1, 2] -= top
    mean = frames.mean(axis=(1, 2), keepdims=True)
    std = np.sqrt(frames.var(axis=(1, 2), keepdims=True))
    images = (frames - mean) / (std + 1e-7)
    return torch.from_numpy(images[None].copy()), torch.from_numpy(cams[None])
