"""Post-processing of the PyTorch port against the JAX package's: the numpy
fusion protocol (bit-equal), the torch twin of the device fusion on the
CPU against ``fusion_jax`` (equal point counts, points within 1e-3,
colours equal), PLY files byte-equal, metrics equal, and the fuse CLI
against the JAX fuse CLI on one export directory."""

import json
import os

import numpy as np
import pytest
import torch

from pointmvsnet_tpu import fuse as jfuse
from pointmvsnet_tpu.dataset import io as jio
from pointmvsnet_tpu.postprocess import fusion as jfusion
from pointmvsnet_tpu.postprocess import metrics as jmetrics
from pointmvsnet_tpu.postprocess import ply as jply
from pointmvsnet_tpu.postprocess.fusion_jax import fuse_depth_maps_jax
from pointmvsnet_tpu_torch import fuse
from pointmvsnet_tpu_torch.dataset import io
from pointmvsnet_tpu_torch.postprocess import fusion, metrics, ply
from pointmvsnet_tpu_torch.postprocess.fusion_torch import fuse_depth_maps_torch
from torch_threads import one_torch_thread  # noqa: F401

PAIRS = {0: [1, 2, 3], 1: [0, 2], 2: [1, 3, 4], 3: [2, 4], 4: [3]}   # ragged


def make_scene(nviews=4, h=24, w=32, d_true=10.0, f=60.0, baseline=0.3):
    """A fronto-parallel plane at depth d_true seen by cameras translated
    along x (the scene of tests/test_postprocess.py) → (depths, cams, GT
    points)."""
    cams, depths = [], []
    for v in range(nviews):
        cam = np.zeros((2, 4, 4), np.float32)
        cam[0] = np.eye(4)
        cam[0, 0, 3] = -baseline * v
        cam[1, :3, :3] = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
        cams.append(cam)
        depths.append(np.full((h, w), d_true, np.float32))
    ys, xs = np.mgrid[0:h, 0:w]
    gt = np.stack([(xs - w / 2) * d_true / f, (ys - h / 2) * d_true / f,
                   np.full(xs.shape, d_true)], -1).reshape(-1, 3)
    return depths, cams, gt.astype(np.float32)


def noisy_scene(seed, nviews=5, h=16, w=24):
    rng = np.random.RandomState(seed)
    depths, cams, gt = make_scene(nviews=nviews, h=h, w=w)
    for d in depths:
        d += rng.randn(*d.shape).astype(np.float32) * 0.05
    probs = [rng.rand(*d.shape).astype(np.float32) for d in depths]
    images = [rng.rand(h, w, 3).astype(np.float32) for _ in depths]
    return depths, cams, probs, images, gt


@pytest.mark.parametrize("pairs", [None, PAIRS])
def test_numpy_fusion_equals_jax_package(pairs):
    depths, cams, probs, images, _ = noisy_scene(0)
    kw = dict(probs=probs, images=images, pairs=pairs, prob_threshold=0.4, min_views=2)
    got, want = fusion.fuse_depth_maps(depths, cams, **kw), jfusion.fuse_depth_maps(depths, cams, **kw)
    assert len(got[0]) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed,pairs,with_probs", [(0, PAIRS, True), (1, None, True),
                                                   (2, PAIRS, False)])
def test_torch_fusion_matches_fusion_jax(seed, pairs, with_probs):
    """The bar of tests/test_postprocess.py::test_fusion_jax_matches_numpy:
    equal point counts, points within 1e-3; colours equal."""
    depths, cams, probs, images, _ = noisy_scene(seed)
    kw = dict(probs=probs if with_probs else None, images=images, pairs=pairs,
              prob_threshold=0.4, min_views=2)
    pts, cols = fuse_depth_maps_torch(depths, cams, device="cpu", **kw)
    jpts, jcols = fuse_depth_maps_jax(depths, cams, **kw)
    npts, ncols = fusion.fuse_depth_maps(depths, cams, **kw)
    assert len(pts) > 0 and pts.shape == jpts.shape == npts.shape
    np.testing.assert_allclose(pts, jpts, atol=1e-3)
    np.testing.assert_allclose(pts, npts, atol=1e-3)
    np.testing.assert_array_equal(cols, jcols)
    np.testing.assert_array_equal(cols, ncols)


def test_numpy_and_torch_fusion_agree_at_scale():
    """Five nearly constant 256×320 maps (what few training steps give) with
    cameras 7 px apart: the numpy protocol and the torch twin on the CPU
    keep the same pixels, points within 1e-3 (the bar above), and the
    numpy result is the same in a second run."""
    rng = np.random.RandomState(6)
    h, w = 256, 320
    depths, cams, _ = make_scene(nviews=5, h=h, w=w, d_true=543.0, f=384.0, baseline=10.0)
    depths = [(d + rng.randn(h, w) * 0.5).astype(np.float32) for d in depths]
    kw = dict(probs=[rng.rand(h, w).astype(np.float32) for _ in depths],
              prob_threshold=0.1, min_views=2)
    pts, _ = fuse_depth_maps_torch(depths, cams, device="cpu", **kw)
    npts, _ = fusion.fuse_depth_maps(depths, cams, **kw)
    assert len(pts) > 0.5 * 5 * h * w and pts.shape == npts.shape
    np.testing.assert_allclose(pts, npts, atol=1e-3)
    np.testing.assert_array_equal(fusion.fuse_depth_maps(depths, cams, **kw)[0], npts)


def test_torch_fusion_recovers_plane_and_rejects_ragged_shapes():
    depths, cams, gt = make_scene()
    pts, cols = fuse_depth_maps_torch(depths, cams, min_views=2, device="cpu")
    assert cols is None and len(pts) > 0.5 * len(gt)
    np.testing.assert_allclose(pts[:, 2], 10.0, atol=1e-3)
    with pytest.raises(ValueError, match="uniform"):
        fuse_depth_maps_torch(depths[:2] + [depths[2][:-1]], cams[:3], device="cpu")


def test_torch_fusion_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    depths, cams, _ = make_scene()
    with pytest.raises(RuntimeError, match="CUDA"):
        fuse_depth_maps_torch(depths, cams)


@pytest.mark.parametrize("with_colors", [True, False])
def test_ply_byte_equal(tmp_path, with_colors):
    rng = np.random.RandomState(3)
    pts = rng.rand(100, 3).astype(np.float32)
    cols = (rng.rand(100, 3) * 255).astype(np.uint8) if with_colors else None
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    ply.write_ply(a, pts, cols)
    jply.write_ply(b, pts, cols)
    assert open(a, "rb").read() == open(b, "rb").read()
    for got, want in zip(ply.read_ply(b), jply.read_ply(a)):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


def test_metrics_equal_jax_package():
    rng = np.random.RandomState(4)
    gt = rng.rand(400, 3).astype(np.float32) * 10
    pred = np.concatenate([gt[:200] + rng.randn(200, 3).astype(np.float32) * 0.1,
                           gt[:50] + np.float32([30, 0, 0])])
    obs = (np.ones((10, 10, 10), bool), np.zeros(3, np.float32), 1.0)
    plane = np.array([0, 0, 1, -5], np.float32)
    for kw in [{}, dict(max_dist=50.0), dict(max_dist=50.0, obs_mask=obs),
               dict(max_dist=50.0, obs_mask=obs, gt_plane=plane)]:
        assert metrics.point_cloud_metrics(pred, gt, **kw) == \
            jmetrics.point_cloud_metrics(pred, gt, **kw)
    assert metrics.point_cloud_metrics(pred[:0], gt) == jmetrics.point_cloud_metrics(pred[:0], gt)
    np.testing.assert_array_equal(metrics.apply_obs_mask(pred, obs), jmetrics.apply_obs_mask(pred, obs))
    np.testing.assert_array_equal(metrics.apply_plane_mask(gt, plane),
                                  jmetrics.apply_plane_mask(gt, plane))


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    """An export directory as eval_file_logger writes it: final flow2 depth
    at 24×32 with noise, coarse init, probabilities at a quarter of the
    resolution, reference images at twice it (so the fuse CLI resizes
    them), for two scans; plus a GT cloud for scan 7."""
    root = tmp_path_factory.mktemp("fuse")
    rng = np.random.RandomState(5)
    for scan in (7, 8):
        depths, cams, gt = make_scene(nviews=4)
        scan_dir = root / "depths" / f"scan{scan}"
        scan_dir.mkdir(parents=True)
        for v, (d, c) in enumerate(zip(depths, cams)):
            stem = str(scan_dir / f"{v:08d}")
            d = d + rng.randn(*d.shape).astype(np.float32) * 0.03
            jio.write_pfm(stem + "_init.pfm", d * 0.9)
            jio.write_pfm(stem + "_flow2.pfm", d)
            jio.write_pfm(stem + "_prob.pfm", (0.5 + 0.5 * rng.rand(6, 8)).astype(np.float32))
            jio.write_cam(stem + ".txt", c)
            io.write_png(stem + ".png", (rng.rand(48, 64, 3) * 255).astype(np.uint8))
    (root / "gt").mkdir()
    jply.write_ply(str(root / "gt" / "scan7.ply"), gt)
    return root


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_fuse_cli_matches_jax_fuse_cli(export_dir, tmp_path, backend):
    args = ["--depth_dir", str(export_dir / "depths"), "--min_views", "2",
            "--prob_threshold", "0.6", "--gt_dir", str(export_dir / "gt")]
    jfuse.main(args + ["--out", str(tmp_path / "jax")])
    got = fuse.main(args + ["--out", str(tmp_path / "port"), "--backend", backend,
                            "--device", "cpu"])
    want = json.load(open(tmp_path / "jax" / "fusion_results.json"))
    assert sorted(got) == sorted(want) == ["scan7", "scan8"]
    assert json.load(open(tmp_path / "port" / "fusion_results.json")) == got
    for scan in want:
        assert got[scan]["backend"] == backend
        assert got[scan]["n_points"] == want[scan]["n_points"] > 0
        pts, cols = ply.read_ply(str(tmp_path / "port" / f"{scan}.ply"))
        jpts, jcols = jply.read_ply(str(tmp_path / "jax" / f"{scan}.ply"))
        np.testing.assert_allclose(pts, jpts, atol=1e-3)
        # colours: linear resize of uint8 within one level of cv2's fixed point
        assert np.abs(cols.astype(int) - jcols).max() <= 1
    for key in ("accuracy", "completeness", "overall"):
        assert abs(got["scan7"][key] - want["scan7"][key]) < 1e-3


def test_fuse_cli_ragged_scan_takes_numpy(export_dir, tmp_path, capsys):
    import shutil
    root = tmp_path / "depths"
    shutil.copytree(export_dir / "depths" / "scan7", root / "scan7")
    d = io.load_pfm(str(root / "scan7" / "00000001_flow2.pfm"))
    io.write_pfm(str(root / "scan7" / "00000001_flow2.pfm"), d[:-4])
    res = fuse.main(["--depth_dir", str(root), "--out", str(tmp_path / "o"),
                     "--min_views", "1", "--device", "cpu"])
    assert res["scan7"]["backend"] == "numpy"
    assert '"backend": "numpy"' in capsys.readouterr().out
    assert os.path.isfile(tmp_path / "o" / "scan7.ply")


def test_fuse_cli_defaults_to_cuda(export_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fuse.main(["--depth_dir", str(export_dir / "depths"), "--out", str(tmp_path)])
