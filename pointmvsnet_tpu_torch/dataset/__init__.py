"""Host-side data: MVSNet-format I/O, preprocessing, the DTU and Tanks &
Temples datasets, the batch loader and synthetic scenes. Exports what
``pointmvsnet_tpu/dataset/__init__.py`` exports."""

from pointmvsnet_tpu_torch.dataset.build import build_data_loader
from pointmvsnet_tpu_torch.dataset.io import (
    load_cam,
    load_pair,
    load_pfm,
    write_cam,
    write_pfm,
)

__all__ = [
    "load_cam",
    "load_pair",
    "load_pfm",
    "write_cam",
    "write_pfm",
    "build_data_loader",
]
