"""Serving Predictor of the PyTorch port on the CPU: numpy in, numpy out,
stride-64 crop, and no silent CPU fallback when CUDA is missing."""

import numpy as np
import pytest
import torch

from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
from pointmvsnet_tpu_torch.predictor import Predictor
from torch_threads import one_torch_thread  # noqa: F401


def small_cfg(norm):
    cfg = get_default_cfg()
    cfg.MODEL.NORM = norm
    cfg.MODEL.IMG_BASE_CHANNELS = 4
    cfg.MODEL.VOL_BASE_CHANNELS = 4
    cfg.MODEL.EDGE_CHANNELS = (8,)
    cfg.MODEL.FLOW_CHANNELS = (8, 1)
    cfg.MODEL.TEST.IMG_SCALES = (0.25, 0.5)
    cfg.MODEL.TEST.INTER_SCALES = (0.75, 0.375)
    cfg.DATA.TEST.NUM_VIRTUAL_PLANE = 8
    return cfg


@pytest.mark.parametrize("norm", ["bn", "gn"])
def test_predictor_end_to_end(norm):
    images, cams, _ = make_scene_batch(1, 2, 70, 130, 8, depth_interval=2.5)
    pred = Predictor(small_cfg(norm), device="cpu")
    out = pred((images[0] * 40 + 128), cams[0])
    # 70x130 crops to 64x128; the last flow runs at scale 0.5
    assert out["depth"].shape == (32, 64)
    assert out["confidence"].shape == (8, 16)
    assert np.isfinite(out["depth"]).all() and np.isfinite(out["confidence"]).all()
    d_min, d_max = 425.0, 425.0 + 7 * 2.5
    assert out["depth"].min() >= d_min - 2 and out["depth"].max() <= d_max + 2
    np.testing.assert_array_equal(out["depth"], out["flow2"])


def test_predictor_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Predictor(small_cfg("bn"))
