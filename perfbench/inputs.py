"""The benchmark's inputs, made from ``--seed``: multi-view scenes and
model weights. Both sides of a comparison get the same ones.

Scenes are a copy of the measured program's synthetic generator
(``dataset/synthetic.py::make_scene_batch``): two textured fronto-parallel
half-planes seen by cameras translated along x, so the true depth is
known. Textures come from the seed; cameras and sizes do not, so every
seed asks the same work of the program. ``plane_fracs`` places the planes
within the hypothesis range (the generator's own 0.25 and 0.70 by default).

Weights follow the program's ``utils/convert.py::init_params``
distributions (kernels uniform in ±1/√fan_in, biases 0, BatchNorm scale
and running variance in [0.5, 1.5), shift and running mean N(0, 0.3²), so
eval BatchNorm is no identity), drawn on ``device`` with one generator in
two calls for the whole model.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def rng(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator for one use (``stream``) of a run's seed."""
    words = [seed % 2 ** 32, (seed // 2 ** 32) % 2 ** 32, *stream.encode()]
    return np.random.default_rng(np.random.SeedSequence(words))


def torch_seed(seed: int, stream: str) -> int:
    return int(rng(seed, stream).integers(0, 2 ** 62))


# ------------------------------------------------------------------ scenes

def _upsample_bilinear(small: np.ndarray, h: int, w: int) -> np.ndarray:
    sh, sw = small.shape[:2]

    def taps(n_out, n_in):
        t = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0, n_in - 1)
        i0 = np.floor(t).astype(np.int64)
        return i0, np.minimum(i0 + 1, n_in - 1), (t - i0).astype(np.float32)

    y0, y1, fy = taps(h, sh)
    x0, x1, fx = taps(w, sw)
    rows = small[y0] * (1 - fy)[:, None, None] + small[y1] * fy[:, None, None]
    return rows[:, x0] * (1 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]


def _texture(g: np.random.Generator, h: int, w: int) -> np.ndarray:
    tex = _upsample_bilinear(g.random((h // 8 + 2, w // 8 + 2, 3), np.float32), h, w)
    tex += 0.25 * g.random((h, w, 3), np.float32)
    tex -= tex.min()
    tex /= max(tex.max(), 1e-6)
    return (tex * 255).astype(np.uint8)


def _shift_x(img: np.ndarray, shift: float) -> np.ndarray:
    """out[y, x] = img[y, x − shift], bilinear in x, zero outside."""
    w = img.shape[1]
    src = np.arange(w, dtype=np.float64) - shift
    x0 = np.floor(src).astype(np.int64)
    fx = (src - x0).astype(np.float32)
    out = np.zeros(img.shape, np.float32)
    for xi, wt in ((x0, 1 - fx), (x0 + 1, fx)):
        ok = (xi >= 0) & (xi < w)
        out[:, ok] += img[:, xi[ok]].astype(np.float32) * wt[ok][None, :, None]
    return out


def cameras(views: int, height: int, width: int, depth_min: float, depth_interval: float,
            num_depth: int) -> Tuple[np.ndarray, float, float]:
    """Cam 0 at the origin looking +z, view v translated along x →
    ((V, 2, 4, 4) f32, focal length, baseline)."""
    f = 1.2 * max(height, width)
    k = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]], np.float64)
    baseline = depth_min * 0.012
    cams = np.zeros((views, 2, 4, 4), np.float32)
    for v in range(views):
        e = np.eye(4)
        e[0, 3] = -v * baseline
        cams[v, 0] = e
        cams[v, 1, :3, :3] = k
        cams[v, 1, 3] = [depth_min, depth_interval, num_depth,
                         depth_min + (num_depth - 1) * depth_interval]
    return cams, f, baseline


def render_scene(g: np.random.Generator, views: int, height: int, width: int, num_depth: int,
                 plane_fracs: Sequence[float] = (0.25, 0.70), depth_min: float = 425.0,
                 depth_interval: float = 2.5):
    """One scene → (frames (V, H, W, 3) uint8, cams (V, 2, 4, 4) f32,
    true depth (H, W) f32)."""
    cams, f, baseline = cameras(views, height, width, depth_min, depth_interval, num_depth)
    span = (num_depth - 1) * depth_interval
    d_lo, d_hi = (depth_min + fr * span for fr in plane_fracs)
    split = width // 2
    tex_l, tex_r = _texture(g, height, width), _texture(g, height, width)
    frames = np.zeros((views, height, width, 3), np.uint8)
    for v in range(views):
        img = np.zeros((height, width, 3), np.float32)
        for tex, d, x0, x1 in ((tex_l, d_lo, 0, split), (tex_r, d_hi, split, width)):
            disp = f * (v * baseline) / d
            mask = np.zeros((height, width, 1), np.float32)
            mask[:, x0:x1] = 1
            warped = _shift_x(tex, -disp)
            wm = _shift_x(mask, -disp)[..., 0] > 0
            img[wm] = warped[wm]
        frames[v] = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    depth = np.full((height, width), d_lo, np.float32)
    depth[:, split:] = d_hi
    return frames, cams, depth


def scene_pool(seed: int, count: int, views: int, height: int, width: int, num_depth: int,
               plane_fracs: Sequence[float] = (0.25, 0.70),
               stream: str = "scenes") -> List[Tuple]:
    """``count`` scenes of one seed, each (frames, cams, depth)."""
    g = rng(seed, stream)
    return [render_scene(g, views, height, width, num_depth, plane_fracs) for _ in range(count)]


# ----------------------------------------------------------------- weights

def weights(template: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """A state_dict with ``template``'s names and shapes, drawn from the
    seed on ``device``: one uniform and one normal draw for all leaves."""
    sizes = [t.numel() for t in template.values()]
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, "weights"))
    uni = torch.rand(sum(sizes), generator=gen, device=device)
    nor = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, t), n in zip(template.items(), sizes):
        u, z = uni[at:at + n].view(t.shape), nor[at:at + n].view(t.shape)
        at += n
        leaf, is_norm = name.rsplit(".", 1)[-1], ".norm." in name
        if leaf == "num_batches_tracked":
            out[name] = torch.zeros(t.shape, dtype=t.dtype, device=device)
        elif leaf == "running_mean" or (is_norm and leaf == "bias"):
            out[name] = 0.3 * z
        elif leaf == "running_var" or (is_norm and leaf == "weight"):
            out[name] = 0.5 + u
        elif leaf == "bias":
            out[name] = torch.zeros_like(u)
        else:
            if leaf == "kernel":                    # EdgeConv (2C, F)
                fan_in = t.shape[0]
            elif ".deconvs." in name:               # (I, O, *sp)
                fan_in = t.shape[0] * int(np.prod(t.shape[2:]))
            else:                                   # (O, I, *sp)
                fan_in = int(np.prod(t.shape[1:]))
            bound = fan_in ** -0.5
            out[name] = (2 * u - 1) * bound
    return {k: v.contiguous() for k, v in out.items()}
