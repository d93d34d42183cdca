"""Binary little-endian PLY point clouds (x y z [r g b]): the port's copy of
``pointmvsnet_tpu/postprocess/ply.py``."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def write_ply(path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None) -> None:
    """points (N, 3) float; colors (N, 3) uint8 or None."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    with_color = colors is not None
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if with_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if with_color:
            rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = points
            rec["rgb"] = np.asarray(colors, np.uint8)
            rec.tofile(f)
        else:
            points.astype("<f4").tofile(f)


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        n = 0
        props = []
        while True:
            line = f.readline().strip()
            if line.startswith(b"element vertex"):
                n = int(line.split()[-1])
            elif line.startswith(b"property"):
                props.append(line.split()[-1].decode())
            elif line == b"end_header":
                break
        has_color = "red" in props
        if has_color:
            rec = np.fromfile(f, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)], count=n)
            return rec["xyz"].copy(), rec["rgb"].copy()
        pts = np.fromfile(f, dtype="<f4", count=n * 3).reshape(n, 3)
        return pts, None
