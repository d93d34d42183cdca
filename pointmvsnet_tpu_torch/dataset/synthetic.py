"""Synthetic MVS scenes: the port's numpy-only copy of
``pointmvsnet_tpu/dataset/synthetic.py :: make_scene_batch`` (in memory),
``make_synthetic_dtu`` (a DTU training-release tree of PNGs or an
eval-release tree of JPEGs on disk) and ``make_synthetic_tanks`` (a Tanks
& Temples tree of JPEGs). Files keep the JAX package's names and layouts;
PNGs are written by ``dataset/io.py::write_png``, JPEGs by
``dataset/jpeg.py::write_jpeg``.

Two textured fronto-parallel half-planes seen by cameras translated along
x, so the true depth is known and plane-sweep stereo can recover it. The
JAX package renders with cv2 (cubic texture upsampling, ``warpAffine``);
here the texture is bilinearly upsampled and each view is an exact
x-translation with bilinear taps and a zero border, in numpy. The pixels
therefore differ from the JAX package's; the geometry (cameras, depths,
disparities) is the same.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from pointmvsnet_tpu_torch.dataset.io import (load_cam, load_pfm, write_cam, write_jpeg,
                                              write_pfm, write_png)
from pointmvsnet_tpu_torch.dataset.preprocess import norm_image


def _upsample_bilinear(small: np.ndarray, h: int, w: int) -> np.ndarray:
    """(h', w', C) → (h, w, C), pixel-center aligned, edges clamped."""
    sh, sw = small.shape[:2]

    def taps(n_out, n_in):
        t = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0, n_in - 1)
        i0 = np.floor(t).astype(np.int64)
        i1 = np.minimum(i0 + 1, n_in - 1)
        return i0, i1, (t - i0).astype(np.float32)

    y0, y1, fy = taps(h, sh)
    x0, x1, fx = taps(w, sw)
    rows = (small[y0] * (1 - fy)[:, None, None]
            + small[y1] * fy[:, None, None])
    return rows[:, x0] * (1 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]


def _texture(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """Smooth random RGB texture with enough gradient for photometric cost."""
    small = rng.rand(h // 8 + 2, w // 8 + 2, 3).astype(np.float32)
    tex = _upsample_bilinear(small, h, w)
    tex += 0.25 * rng.rand(h, w, 3).astype(np.float32)
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


def _make_cams(num_views: int, height: int, width: int, depth_min: float,
               depth_interval: float, num_depth: int):
    """Cam 0 at the origin looking +z, view v translated along x.
    → (cams list, focal f, baseline)."""
    f = 1.2 * max(height, width)
    K = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]],
                 np.float64)
    baseline = depth_min * 0.012
    cams = []
    for v in range(num_views):
        E = np.eye(4)
        E[0, 3] = -v * baseline
        cam = np.zeros((2, 4, 4), np.float32)
        cam[0] = E
        cam[1, :3, :3] = K
        cam[1, 3] = [depth_min, depth_interval, num_depth,
                     depth_min + (num_depth - 1) * depth_interval]
        cams.append(cam)
    return cams, f, baseline


def plane_depths(depth_min: float, depth_interval: float, num_depth: int):
    """Depths of the left and right half-planes: at 25% and 70% of the
    hypothesis range."""
    return (depth_min + 0.25 * (num_depth - 1) * depth_interval,
            depth_min + 0.70 * (num_depth - 1) * depth_interval)


def _render_two_planes(v, f, baseline, height, width, d_lo, d_hi,
                       tex_l, tex_r) -> np.ndarray:
    """View v of the two textured half-planes (float RGB in [0, 255])."""
    img = np.zeros((height, width, 3), np.float32)
    split = width // 2
    for tex, d, x0, x1 in [(tex_l, d_lo, 0, split), (tex_r, d_hi, split, width)]:
        disp = f * (v * baseline) / d
        mask = np.zeros((height, width, 1), np.float32)
        mask[:, x0:x1] = 1
        warped = _shift_x(tex, -disp)
        wm = _shift_x(mask, -disp)[..., 0] > 0
        img[wm] = warped[wm]
    return img


def make_scene_batch(batch: int, num_views: int, height: int, width: int,
                     num_depth: int, depth_min: float = 425.0,
                     depth_interval: float = 2.5, seed: int = 0):
    """→ (images (B, V, H, W, 3) float32 standardized per image,
    cams (B, V, 2, 4, 4) float32, gt_depth (B, H, W) float32)."""
    cams, f, baseline = _make_cams(num_views, height, width, depth_min,
                                   depth_interval, num_depth)
    d_lo, d_hi = plane_depths(depth_min, depth_interval, num_depth)
    split = width // 2

    images = np.zeros((batch, num_views, height, width, 3), np.float32)
    gt = np.zeros((batch, height, width), np.float32)
    for b in range(batch):
        rng = np.random.RandomState(seed + b)
        tex_l = _texture(rng, height, width)
        tex_r = _texture(rng, height, width)
        for v in range(num_views):
            img = _render_two_planes(v, f, baseline, height, width,
                                     d_lo, d_hi, tex_l, tex_r)
            images[b, v] = norm_image(img)
        gt[b] = d_lo
        gt[b, :, split:] = d_hi
    cam_batch = np.broadcast_to(np.stack(cams), (batch, num_views, 2, 4, 4))
    return images, np.ascontiguousarray(cam_batch, np.float32), gt


def _write_pair(path: str, num_views: int) -> None:
    """pair.txt: every other view is a source of v, nearest first."""
    with open(path, "w") as fp:
        fp.write(f"{num_views}\n")
        for v in range(num_views):
            others = [u for u in sorted(range(num_views), key=lambda u: (abs(u - v), u))
                      if u != v]
            fp.write(f"{v}\n{len(others)} "
                     + " ".join(f"{u} {100.0 - 10 * i}" for i, u in enumerate(others))
                     + "\n")


def _render_u8(v, f, baseline, height, width, d_lo, d_hi, tex_l, tex_r) -> np.ndarray:
    img = _render_two_planes(v, f, baseline, height, width, d_lo, d_hi, tex_l, tex_r)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def make_synthetic_tanks(root: str, scenes: Sequence[str] = ("Family",),
                         num_views: int = 5, height: int = 128,
                         width: int = 160, depth_min: float = 425.0,
                         depth_interval: float = 2.5, num_depth: int = 96,
                         seed: int = 0, per_scene: dict | None = None) -> None:
    """Create a Tanks & Temples-layout tree under ``root``
    (``<scene>/pair.txt``, ``<scene>/cams/{v:08d}_cam.txt``,
    ``<scene>/images/{v:08d}.jpg``) with the two-plane scene.
    ``per_scene``: optional {scene: {height / width / num_depth /
    depth_interval: ...}} overrides (ragged resolutions, per-scene depth
    sampling in the cam files)."""
    rng = np.random.RandomState(seed)
    for scene in scenes:
        ov = dict(per_scene.get(scene, {})) if per_scene else {}
        s_h = int(ov.get("height", height))
        s_w = int(ov.get("width", width))
        s_nd = int(ov.get("num_depth", num_depth))
        s_di = float(ov.get("depth_interval", depth_interval))
        cams, f, baseline = _make_cams(num_views, s_h, s_w, depth_min, s_di, s_nd)
        d_lo, d_hi = plane_depths(depth_min, s_di, s_nd)
        sd = os.path.join(root, scene)
        os.makedirs(os.path.join(sd, "cams"), exist_ok=True)
        os.makedirs(os.path.join(sd, "images"), exist_ok=True)
        _write_pair(os.path.join(sd, "pair.txt"), num_views)
        tex_l = _texture(rng, s_h, s_w)
        tex_r = _texture(rng, s_h, s_w)
        for v in range(num_views):
            write_cam(os.path.join(sd, "cams", f"{v:08d}_cam.txt"), cams[v])
            write_jpeg(os.path.join(sd, "images", f"{v:08d}.jpg"),
                       _render_u8(v, f, baseline, s_h, s_w, d_lo, d_hi, tex_l, tex_r))


def make_synthetic_dtu(root: str, scans: Sequence[int] = (1,), num_views: int = 5,
                       height: int = 128, width: int = 160, depth_min: float = 425.0,
                       depth_interval: float = 2.5, num_depth: int = 48,
                       num_lights: int = 7, seed: int = 0,
                       layout: str = "train", image_ext: str = "jpg") -> None:
    """Create a DTU-layout tree under ``root``.

    ``layout="train"``: the training release, shared ``Cameras/`` (cams +
    pair.txt), ``Rectified/scan{n}_train/`` PNGs for every view and light
    (gain 0.75 + 0.08·light), ``Depths/scan{n}_train/`` PFMs (each view's
    depth map sees the planes shifted by its disparity).
    ``layout="eval"``: the eval release,
    ``Eval/scan{n}/{images,cams}/{view:08d}.{jpg,txt}`` and a per-scan
    ``pair.txt``, no depth; ``image_ext="png"`` writes its images as PNGs
    instead (both packages' test sets read ``{view:08d}.png`` where there
    is no JPEG), so that readers of both packages see the same pixels. The
    scene is the two textured half-planes of ``make_scene_batch``."""
    if layout not in ("train", "eval"):
        raise ValueError(f"layout {layout!r}: want 'train' or 'eval'")
    if image_ext not in ("jpg", "png"):
        raise ValueError(f"image_ext {image_ext!r}: want 'jpg' or 'png'")
    rng = np.random.RandomState(seed)
    cams, f, baseline = _make_cams(num_views, height, width, depth_min,
                                   depth_interval, num_depth)
    if layout == "train":
        os.makedirs(os.path.join(root, "Cameras"), exist_ok=True)
        for v in range(num_views):
            write_cam(os.path.join(root, "Cameras", f"{v:08d}_cam.txt"), cams[v])
        _write_pair(os.path.join(root, "Cameras", "pair.txt"), num_views)

    d_lo, d_hi = plane_depths(depth_min, depth_interval, num_depth)
    split = width // 2
    for scan in scans:
        if layout == "eval":
            scan_dir = os.path.join(root, "Eval", f"scan{scan}")
            img_dir = os.path.join(scan_dir, "images")
            os.makedirs(img_dir, exist_ok=True)
            os.makedirs(os.path.join(scan_dir, "cams"), exist_ok=True)
            for v in range(num_views):
                write_cam(os.path.join(scan_dir, "cams", f"{v:08d}_cam.txt"), cams[v])
            _write_pair(os.path.join(scan_dir, "pair.txt"), num_views)
        else:
            img_dir = os.path.join(root, "Rectified", f"scan{scan}_train")
            dep_dir = os.path.join(root, "Depths", f"scan{scan}_train")
            os.makedirs(img_dir, exist_ok=True)
            os.makedirs(dep_dir, exist_ok=True)
        tex_l = _texture(rng, height, width)
        tex_r = _texture(rng, height, width)
        for v in range(num_views):
            img = _render_u8(v, f, baseline, height, width, d_lo, d_hi, tex_l, tex_r)
            if layout == "eval":
                write = write_png if image_ext == "png" else write_jpeg
                write(os.path.join(img_dir, f"{v:08d}.{image_ext}"), img)
                continue
            for light in range(num_lights):
                gain = 0.75 + 0.08 * light
                out = np.clip(img.astype(np.float32) * gain, 0, 255).astype(np.uint8)
                write_png(os.path.join(img_dir, f"rect_{v + 1:03d}_{light}_r5000.png"), out)
            depth = np.full((height, width), d_lo, np.float32)
            depth[:, split:] = d_hi
            for d, x0, x1 in [(d_lo, 0, split), (d_hi, split, width)]:
                disp = int(round(f * (v * baseline) / d))
                depth[:, max(0, x0 - disp):max(0, x1 - disp)] = d
            write_pfm(os.path.join(dep_dir, f"depth_map_{v:04d}.pfm"), depth)


def true_cloud(root: str, views: int, scan: int = 1, stride: int = 1) -> np.ndarray:
    """The scene's true points: every ``stride``-th pixel in x and y of each
    view's true depth map (``Depths/scan{n}_train`` of a training-release
    tree that ``make_synthetic_dtu`` wrote) back-projected through its
    camera, pixel (x, y) at integer coordinates as fusion takes them. →
    (N, 3) float32."""
    pts = []
    for v in range(views):
        d = load_pfm(os.path.join(root, "Depths", f"scan{scan}_train",
                                  f"depth_map_{v:04d}.pfm")).astype(np.float64)
        cam = load_cam(os.path.join(root, "Cameras", f"{v:08d}_cam.txt")).astype(np.float64)
        ys, xs = np.mgrid[0:d.shape[0]:stride, 0:d.shape[1]:stride]
        uv1 = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)], 1)
        pc = uv1 @ np.linalg.inv(cam[1, :3, :3]).T * d[ys, xs].ravel()[:, None]
        pts.append((pc - cam[0, :3, 3]) @ cam[0, :3, :3])
    return np.concatenate(pts).astype(np.float32)
