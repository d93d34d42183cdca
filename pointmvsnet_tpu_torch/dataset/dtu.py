"""DTU training / validation set (Yao Yao's preprocessed MVSNet layout): the
port's copy of ``pointmvsnet_tpu/dataset/dtu.py :: DTUTrainValDataset``,
reading PNGs with ``dataset/io.py::read_png`` instead of cv2.

    <root>/Cameras/pair.txt
    <root>/Cameras/{view:08d}_cam.txt
    <root>/Rectified/scan{n}_train/rect_{view+1:03d}_{light}_r5000.png
    <root>/Depths/scan{n}_train/depth_map_{view:04d}.pfm

Each item is a dict of numpy arrays, channels last:

    images:    (V, H, W, 3) float32, per-image standardized
    cams:      (V, 2, 4, 4) float32 (extrinsic | K + depth range)
    gt_depth:  (H, W, 1)    float32 at image resolution, zeros invalid
    scan, ref_view: int32

The test set (``DTUTestDataset``) waits for the test-CLI slice.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from pointmvsnet_tpu_torch.dataset.io import load_cam, load_pair, load_pfm, read_png
from pointmvsnet_tpu_torch.dataset.preprocess import (
    mask_depth_image,
    norm_image,
    resize_image,
)
from pointmvsnet_tpu_torch.dataset.splits import DTU_TRAIN_SCANS, DTU_VAL_SCANS

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
            images.append(norm_image(read_png(img_path)))
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
