"""Post-processing of exported depth maps: multi-view fusion into a point
cloud (numpy, ``fusion.py``; on the card, ``fusion_torch.py``), PLY files
and accuracy / completeness metrics. The port's copy of
``pointmvsnet_tpu/postprocess``, with ``fusion_torch`` in place of
``fusion_jax``."""

from pointmvsnet_tpu_torch.postprocess.fusion import fuse_depth_maps
from pointmvsnet_tpu_torch.postprocess.metrics import (
    apply_obs_mask,
    apply_plane_mask,
    point_cloud_metrics,
)
from pointmvsnet_tpu_torch.postprocess.ply import read_ply, write_ply

__all__ = ["fuse_depth_maps", "write_ply", "read_ply", "point_cloud_metrics",
           "apply_obs_mask", "apply_plane_mask"]
