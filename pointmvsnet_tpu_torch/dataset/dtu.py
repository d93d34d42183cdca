"""DTU (Yao Yao's preprocessed MVSNet layouts): the port's copy of
``pointmvsnet_tpu/dataset/dtu.py :: DTUTrainValDataset, DTUTestDataset``,
reading images with ``dataset/io.py::read_image`` (PNG or JPEG) instead of
cv2. Training release::

    <root>/Cameras/pair.txt
    <root>/Cameras/{view:08d}_cam.txt
    <root>/Rectified/scan{n}_train/rect_{view+1:03d}_{light}_r5000.png
    <root>/Depths/scan{n}_train/depth_map_{view:04d}.pfm

Eval release (test split only)::

    <root>/Eval/scan{n}/images/{view:08d}.jpg   (or <root>/scan{n}/...)
    <root>/Eval/scan{n}/cams/{view:08d}_cam.txt
    <root>/Eval/scan{n}/pair.txt                 (else <root>/Cameras/pair.txt)

Each item is a dict of numpy arrays, channels last:

    images:    (V, H, W, 3) float32, per-image standardized
    cams:      (V, 2, 4, 4) float32 (extrinsic | K + depth range)
    gt_depth:  (H, W, 1)    float32 at image resolution, zeros invalid
               (train / val; test only where the tree has Depths/)
    scan, ref_view: int32
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional, Sequence

import numpy as np

from pointmvsnet_tpu_torch.dataset.io import load_cam, load_pair, load_pfm, read_image
from pointmvsnet_tpu_torch.dataset.preprocess import (
    crop_mvs_input,
    mask_depth_image,
    norm_image,
    resize_image,
    scale_mvs_input,
)
from pointmvsnet_tpu_torch.dataset.splits import (
    DTU_EVAL_SCANS,
    DTU_TRAIN_SCANS,
    DTU_VAL_SCANS,
)

NUM_LIGHTS = 7  # lighting conditions per view in the release


class DTUTrainValDataset:
    """Training split (every light of every view of every scan) or
    validation split (light 3 only)."""

    def __init__(self, root_dir: str, mode: str = "train", num_view: int = 3,
                 num_virtual_plane: int = 48, interval_scale: float = 1.06):
        if mode not in ("train", "val"):
            raise ValueError(f"mode {mode!r}: want 'train' or 'val'")
        self.root = root_dir
        self.mode = mode
        self.num_view = num_view
        self.num_virtual_plane = num_virtual_plane
        self.interval_scale = interval_scale
        scans = DTU_TRAIN_SCANS if mode == "train" else DTU_VAL_SCANS
        self.scans = [s for s in scans if os.path.isdir(self._scan_dir(s))]
        self.pair = load_pair(os.path.join(self.root, "Cameras", "pair.txt"))
        lights = range(NUM_LIGHTS) if mode == "train" else [3]
        self.index = [
            (scan, ref, light)
            for scan in self.scans
            for ref in self.pair
            if len(self.pair[ref]) >= num_view - 1
            for light in lights
        ]

    def _scan_dir(self, scan: int) -> str:
        return os.path.join(self.root, "Rectified", f"scan{scan}_train")

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        scan, ref, light = self.index[idx]
        views = [ref] + [v for v, _ in self.pair[ref][: self.num_view - 1]]
        images, cams = [], []
        for v in views:
            img_path = os.path.join(self._scan_dir(scan), f"rect_{v + 1:03d}_{light}_r5000.png")
            images.append(norm_image(read_image(img_path)))
            cams.append(load_cam(
                os.path.join(self.root, "Cameras", f"{v:08d}_cam.txt"),
                interval_scale=self.interval_scale,
                num_depth=self.num_virtual_plane))
        depth_path = os.path.join(self.root, "Depths", f"scan{scan}_train",
                                  f"depth_map_{ref:04d}.pfm")
        gt = load_pfm(depth_path)
        ref_cam = cams[0]
        d_min = float(ref_cam[1, 3, 0])
        d_max = float(ref_cam[1, 3, 3]) if ref_cam[1, 3, 3] > 0 else d_min + (
            self.num_virtual_plane - 1) * float(ref_cam[1, 3, 1])
        gt = mask_depth_image(gt, d_min, d_max)
        # GT depth goes to the image resolution (nearest); the loss resizes
        # it to each output's resolution on the device
        h, w = images[0].shape[:2]
        if gt.shape[:2] != (h, w):
            gt = resize_image(gt, (h, w))
        return {
            "images": np.stack(images).astype(np.float32),
            "cams": np.stack(cams).astype(np.float32),
            "gt_depth": gt[..., None].astype(np.float32),
            "scan": np.int32(scan),
            "ref_view": np.int32(ref),
        }


class DTUTestDataset:
    """Evaluation split: every reference view of each scan with at least
    ``num_view − 1`` sources. Finds per scan which release the tree holds
    (eval release first, then the training release at light
    ``light_idx``); both may coexist in one root. Images are scaled to fit
    (``img_height``, ``img_width``) (linear), centre-cropped to multiples
    of ``base`` and standardized."""

    def __init__(self, root_dir: str, num_view: int = 5,
                 num_virtual_plane: int = 96, interval_scale: float = 0.8,
                 img_height: int = 512, img_width: int = 640,
                 scans: Optional[Sequence[int]] = None, base: int = 64,
                 light_idx: int = 3):
        self.root = root_dir
        self.num_view = num_view
        self.num_virtual_plane = num_virtual_plane
        self.interval_scale = interval_scale
        self.img_height = img_height
        self.img_width = img_width
        self.base = base
        self.light_idx = light_idx
        # Each view is a source of several items (5 at V=5): decode it once.
        # 49 entries hold a whole DTU eval scan, 282 MB at 1600×1200.
        self._read_image = functools.lru_cache(maxsize=49)(read_image)
        self._layout: Dict[int, tuple] = {}
        for s in DTU_EVAL_SCANS if scans is None else scans:
            found = self._find_scan(s)
            if found is not None:
                self._layout[s] = found
        self.scans = sorted(self._layout)
        shared_pair_path = os.path.join(self.root, "Cameras", "pair.txt")
        shared_pair = load_pair(shared_pair_path) if os.path.isfile(shared_pair_path) else None
        self.pair: Dict[int, dict] = {}
        self.index = []
        for scan in self.scans:
            _, scan_dir = self._layout[scan]
            scan_pair_path = os.path.join(scan_dir, "pair.txt")
            pair = load_pair(scan_pair_path) if os.path.isfile(scan_pair_path) else shared_pair
            if pair is None:
                raise FileNotFoundError(
                    f"no pair.txt for scan {scan}: neither {scan_pair_path} "
                    f"nor {shared_pair_path} exists")
            self.pair[scan] = pair
            self.index.extend((scan, ref) for ref in pair if len(pair[ref]) >= num_view - 1)

    def _find_scan(self, scan: int):
        """→ ("eval" | "train", scan_dir), or None if the scan is absent."""
        for cand in (os.path.join(self.root, "Eval", f"scan{scan}"),
                     os.path.join(self.root, f"scan{scan}")):
            if os.path.isdir(os.path.join(cand, "images")):
                return "eval", cand
        rect = os.path.join(self.root, "Rectified", f"scan{scan}_train")
        if os.path.isdir(rect):
            return "train", rect
        return None

    def _view_paths(self, scan: int, v: int) -> tuple:
        """→ (image path, cam path) of one view under the scan's layout."""
        kind, scan_dir = self._layout[scan]
        if kind == "eval":
            img = os.path.join(scan_dir, "images", f"{v:08d}.jpg")
            if not os.path.isfile(img):
                img = os.path.join(scan_dir, "images", f"{v:08d}.png")
            return img, os.path.join(scan_dir, "cams", f"{v:08d}_cam.txt")
        return (os.path.join(scan_dir, f"rect_{v + 1:03d}_{self.light_idx}_r5000.png"),
                os.path.join(self.root, "Cameras", f"{v:08d}_cam.txt"))

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        scan, ref = self.index[idx]
        views = [ref] + [v for v, _ in self.pair[scan][ref][: self.num_view - 1]]
        images, cams = [], []
        for v in views:
            img_path, cam_path = self._view_paths(scan, v)
            images.append(self._read_image(img_path).astype(np.float32))
            cams.append(load_cam(cam_path, interval_scale=self.interval_scale,
                                 num_depth=self.num_virtual_plane))
        h, w = images[0].shape[:2]
        scale = min(self.img_height / h, self.img_width / w)
        if scale != 1.0:
            images, cams = scale_mvs_input(images, cams, scale)
        images, cams = crop_mvs_input(images, cams, self.img_height, self.img_width,
                                      base=self.base)
        item = {
            "images": np.stack([norm_image(im) for im in images]).astype(np.float32),
            "cams": np.stack(cams).astype(np.float32),
            "scan": np.int32(scan),
            "ref_view": np.int32(ref),
        }
        # depth-map metrics need GT where the tree ships it
        depth_path = os.path.join(self.root, "Depths", f"scan{scan}_train",
                                  f"depth_map_{ref:04d}.pfm")
        if os.path.isfile(depth_path):
            gt = load_pfm(depth_path)
            ih, iw = item["images"].shape[1:3]
            if gt.shape[:2] != (ih, iw):
                gt = resize_image(gt, (ih, iw))
            item["gt_depth"] = gt[..., None].astype(np.float32)
        return item
