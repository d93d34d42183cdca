"""Tanks & Temples (the preprocessed MVSNet release): the port's copy of
``pointmvsnet_tpu/dataset/tanks.py``, reading images with
``dataset/io.py::read_image`` instead of cv2. Layout::

    <root>/<scene>/pair.txt
    <root>/<scene>/cams/{view:08d}_cam.txt
    <root>/<scene>/images/{view:08d}.jpg   (or .png)

Items as the DTU test set's (channels-last images, (V, 2, 4, 4) cams);
``scan`` is the scene's index in the configured scene list. Two quirks of
the real release:

- each cam file's depth line carries its own ``num_depth``;
  ``rescale_depth`` stretches the interval so that the configured
  hypothesis count spans the file's [depth_min, depth_max];
- scenes come at different resolutions; with a ``shape_set`` each scene
  takes the member that keeps most of its pixels (``pick_shape``), so a
  run sees a small set of shapes instead of one box for all.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from pointmvsnet_tpu_torch.dataset.io import load_cam, load_pair, read_image
from pointmvsnet_tpu_torch.dataset.preprocess import crop_mvs_input, norm_image, scale_mvs_input

INTERMEDIATE_SCENES = ["Family", "Francis", "Horse", "Lighthouse", "M60",
                       "Panther", "Playground", "Train"]


def pick_shape(h: int, w: int, shape_set: Sequence[Tuple[int, int]],
               base: int = 64) -> Tuple[int, int]:
    """Best (th, tw) of ``shape_set`` for an (h, w) source under
    scale-to-cover (s = max(th/h, tw/w), capped at 1) and a centre crop:
    among targets the source covers (the crop is then exactly (th, tw)),
    the largest share of source pixels kept, th·tw / (sh·sw); targets it
    cannot cover rank below, by the area their crop would keep."""
    best, best_key = None, None
    for th, tw in shape_set:
        th, tw = (th // base) * base, (tw // base) * base
        if th <= 0 or tw <= 0:
            continue
        s = min(max(th / h, tw / w), 1.0)
        sh, sw = int(round(h * s)), int(round(w * s))
        fh, fw = min(th, sh) // base * base, min(tw, sw) // base * base
        coverable = (fh == th and fw == tw)
        key = (coverable, (th * tw) / (sh * sw) if coverable else fh * fw / (h * w))
        if best_key is None or key > best_key:
            best, best_key = (th, tw), key
    if best is None:
        raise ValueError(f"no usable shape in {shape_set} at base {base}")
    return best


class TanksDataset:
    def __init__(self, root_dir: str, num_view: int = 5,
                 num_virtual_plane: int = 96, interval_scale: float = 1.0,
                 img_height: int = 512, img_width: int = 640,
                 scenes: Optional[Sequence[str]] = None, base: int = 64,
                 rescale_depth: bool = True,
                 shape_set: Optional[Sequence[Tuple[int, int]]] = None):
        self.root = root_dir
        self.num_view = num_view
        self.num_virtual_plane = num_virtual_plane
        self.interval_scale = interval_scale
        self.img_height = img_height
        self.img_width = img_width
        self.base = base
        self.rescale_depth = rescale_depth
        self.shape_set = [tuple(s) for s in shape_set] if shape_set else None
        self._scene_shape: Dict[str, Tuple[int, int]] = {}
        self.scenes = [s for s in (INTERMEDIATE_SCENES if scenes is None else scenes)
                       if os.path.isdir(os.path.join(root_dir, s))]
        self.pairs = {s: load_pair(os.path.join(root_dir, s, "pair.txt")) for s in self.scenes}
        self.index = [(s, ref) for s in self.scenes for ref in self.pairs[s]
                      if len(self.pairs[s][ref]) >= num_view - 1]

    def _target_shape(self, scene: str, h: int, w: int) -> Tuple[int, int]:
        """(img_height, img_width), or with a shape_set the member picked
        once per scene (all views of a scene share a resolution)."""
        if self.shape_set is None:
            return self.img_height, self.img_width
        if scene not in self._scene_shape:
            self._scene_shape[scene] = pick_shape(h, w, self.shape_set, self.base)
        return self._scene_shape[scene]

    def _rescale_cam_depth(self, cam: np.ndarray) -> np.ndarray:
        """Stretch the (already interval_scale-d) interval so that
        ``num_virtual_plane`` hypotheses span what the file's own
        num_depth did."""
        nd_file = float(cam[1, 3, 2])
        d = self.num_virtual_plane
        if self.rescale_depth and nd_file >= 2 and int(nd_file) != d:
            cam = cam.copy()
            cam[1, 3, 1] *= (nd_file - 1.0) / (d - 1.0)
            cam[1, 3, 2] = d
        return cam

    def __len__(self) -> int:
        return len(self.index)

    def _image_path(self, scene: str, view: int) -> str:
        for ext in (".jpg", ".png"):
            p = os.path.join(self.root, scene, "images", f"{view:08d}{ext}")
            if os.path.isfile(p):
                return p
        raise FileNotFoundError(os.path.join(self.root, scene, "images", f"{view:08d}.jpg"))

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        scene, ref = self.index[idx]
        views = [ref] + [v for v, _ in self.pairs[scene][ref][: self.num_view - 1]]
        images, cams = [], []
        for v in views:
            images.append(read_image(self._image_path(scene, v)).astype(np.float32))
            cams.append(self._rescale_cam_depth(load_cam(
                os.path.join(self.root, scene, "cams", f"{v:08d}_cam.txt"),
                interval_scale=self.interval_scale, num_depth=self.num_virtual_plane)))
        h, w = images[0].shape[:2]
        th, tw = self._target_shape(scene, h, w)
        if self.shape_set is None:
            scale = min(th / h, tw / w)               # fixed box: scale to fit
        else:
            scale = min(max(th / h, tw / w), 1.0)     # scale to cover, crop to (th, tw)
        if scale != 1.0:
            images, cams = scale_mvs_input(images, cams, scale)
        images, cams = crop_mvs_input(images, cams, th, tw, base=self.base)
        return {
            "images": np.stack([norm_image(im) for im in images]).astype(np.float32),
            "cams": np.stack(cams).astype(np.float32),
            "scan": np.int32(self.scenes.index(scene)),
            "ref_view": np.int32(ref),
        }
