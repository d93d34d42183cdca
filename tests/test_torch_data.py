"""The data plane of the PyTorch port (numpy and the standard library, no
cv2) vs the JAX package's: PNG read / write against cv2, PFM / cam / pair
round trips across both packages, the nearest resize against
cv2.INTER_NEAREST, and DTU training / validation items and batches equal,
key for key, on the same tree."""

import glob
import os

import cv2
import numpy as np
import pytest

from pointmvsnet_tpu.config import get_default_cfg as jget_default_cfg
from pointmvsnet_tpu.dataset import io as jio
from pointmvsnet_tpu.dataset.build import build_data_loader as jbuild_data_loader
from pointmvsnet_tpu.dataset.dtu import DTUTrainValDataset as JDTUTrainValDataset
from pointmvsnet_tpu.dataset.synthetic import make_synthetic_dtu as jmake_synthetic_dtu
from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.dataset import io
from pointmvsnet_tpu_torch.dataset.build import build_data_loader
from pointmvsnet_tpu_torch.dataset.dtu import DTUTrainValDataset
from pointmvsnet_tpu_torch.dataset.preprocess import resize_image
from pointmvsnet_tpu_torch.dataset.synthetic import make_synthetic_dtu
from torch_threads import one_torch_thread  # noqa: F401

H, W, D = 48, 64, 16
TREE = dict(scans=[2, 3], num_views=3, height=H, width=W, num_depth=D)


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax_dtu"))
    jmake_synthetic_dtu(root, **TREE)
    return root


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_dtu"))
    make_synthetic_dtu(root, **TREE)
    return root


def cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


# ------------------------------------------------------------------ PNG

def test_read_png_equals_cv2_on_cv2_written(jax_tree):
    paths = sorted(glob.glob(os.path.join(jax_tree, "Rectified", "*", "*.png")))
    assert len(paths) == 2 * 3 * 7
    for p in paths:
        np.testing.assert_array_equal(io.read_png(p), cv2_rgb(p))


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_write_png_cv2_round_trip(tmp_path, filters, channels):
    rng = np.random.RandomState(channels)
    img = (rng.rand(29, 41, channels) * 255).astype(np.uint8)
    if filters == "mixed":
        filters = list(rng.randint(0, 5, 29))
    path = str(tmp_path / "x.png")
    io.write_png(path, img[..., 0] if channels == 1 else img, filters=filters)
    want = np.repeat(img, 3, axis=2) if channels == 1 else img[..., :3]
    np.testing.assert_array_equal(cv2_rgb(path), want)
    np.testing.assert_array_equal(io.read_png(path), want)


def test_read_png_cv2_grey_and_rgba(tmp_path):
    rng = np.random.RandomState(3)
    for img in [(rng.rand(17, 23) * 255).astype(np.uint8),
                (rng.rand(17, 23, 4) * 255).astype(np.uint8)]:
        path = str(tmp_path / "y.png")
        cv2.imwrite(path, img)
        np.testing.assert_array_equal(io.read_png(path), cv2_rgb(path))


def test_read_png_rejects_16_bit(tmp_path):
    path = str(tmp_path / "z.png")
    cv2.imwrite(path, np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match="8-bit"):
        io.read_png(path)


# ------------------------------------------------------------------ PFM, cam, pair

def test_pfm_round_trips(tmp_path):
    rng = np.random.RandomState(0)
    for arr in [rng.randn(13, 17).astype(np.float32), rng.randn(5, 7, 3).astype(np.float32)]:
        io.write_pfm(str(tmp_path / "a.pfm"), arr)
        np.testing.assert_array_equal(io.load_pfm(str(tmp_path / "a.pfm")), arr)
        np.testing.assert_array_equal(jio.load_pfm(str(tmp_path / "a.pfm")), arr)
        jio.write_pfm(str(tmp_path / "b.pfm"), arr)
        np.testing.assert_array_equal(io.load_pfm(str(tmp_path / "b.pfm")), arr)


def test_cam_round_trips(tmp_path, jax_tree):
    rng = np.random.RandomState(1)
    cam = np.zeros((2, 4, 4), np.float32)
    cam[0] = rng.randn(4, 4)
    cam[1, :3, :3] = rng.rand(3, 3) * 500
    cam[1, 3] = [425.0, 2.5, 48, 542.5]
    io.write_cam(str(tmp_path / "c.txt"), cam)
    np.testing.assert_array_equal(io.load_cam(str(tmp_path / "c.txt")), cam)
    np.testing.assert_array_equal(jio.load_cam(str(tmp_path / "c.txt")), cam)
    for path in glob.glob(os.path.join(jax_tree, "Cameras", "*_cam.txt")):
        for kw in [{}, dict(interval_scale=1.06, num_depth=D)]:
            np.testing.assert_array_equal(io.load_cam(path, **kw), jio.load_cam(path, **kw))


def test_pair_matches(jax_tree, port_tree):
    for root in (jax_tree, port_tree):
        path = os.path.join(root, "Cameras", "pair.txt")
        assert io.load_pair(path) == jio.load_pair(path)


# ------------------------------------------------------------------ resize

@pytest.mark.parametrize("src", [(128, 160), (512, 640), (37, 53)])
@pytest.mark.parametrize("dst", [(512, 640), (64, 80), (256, 320), (37, 53), (99, 101)])
def test_nearest_resize_equals_cv2(src, dst):
    img = np.random.RandomState(0).rand(*src).astype(np.float32)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(resize_image(img, dst), want)


# ------------------------------------------------------------------ DTU

def assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("tree", ["jax_tree", "port_tree"])
def test_dtu_items_equal(request, mode, tree):
    root = request.getfixturevalue(tree)
    kw = dict(mode=mode, num_view=3, num_virtual_plane=D, interval_scale=1.06)
    jds, ds = JDTUTrainValDataset(root, **kw), DTUTrainValDataset(root, **kw)
    assert ds.index == jds.index and len(ds) == (21 if mode == "train" else 3)
    for i in range(len(ds)):
        assert_items_equal(ds[i], jds[i])


def test_gt_resized_to_image(tmp_path, jax_tree):
    """GT at a lower resolution than the images (as in the DTU training
    release) is resized by the nearest rule in both packages."""
    import shutil
    root = str(tmp_path / "tree")
    shutil.copytree(jax_tree, root)
    for p in glob.glob(os.path.join(root, "Depths", "*", "*.pfm")):
        jio.write_pfm(p, jio.load_pfm(p)[::4, ::4])
    kw = dict(mode="train", num_view=3, num_virtual_plane=D)
    item = DTUTrainValDataset(root, **kw)[5]
    assert item["gt_depth"].shape == (H, W, 1)
    assert_items_equal(item, JDTUTrainValDataset(root, **kw)[5])


@pytest.mark.parametrize("mode", ["train", "val"])
def test_loader_batches_equal(jax_tree, mode):
    cfgs = []
    for make in (get_default_cfg, jget_default_cfg):
        cfg = make()
        for split in ("TRAIN", "VAL"):
            cfg.DATA[split].ROOT_DIR = jax_tree
        cfg.DATA.TRAIN.NUM_VIRTUAL_PLANE = D
        cfg.TRAIN.BATCH_SIZE = 2
        cfgs.append(cfg)
    loader, jloader = build_data_loader(cfgs[0], mode), jbuild_data_loader(cfgs[1], mode)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == len(loader) > 0
        for g, w in zip(got, want):
            assert_items_equal(g, w)


def test_test_split_not_ported(jax_tree):
    """The test split is ported now: it builds the DTU test set and keeps
    its last partial batch; an unknown split still raises."""
    cfg = get_default_cfg()
    cfg.DATA.TEST.ROOT_DIR = jax_tree
    cfg.DATA.TEST.NUM_VIEW = 3
    loader = build_data_loader(cfg, "test")
    assert type(loader.dataset).__name__ == "DTUTestDataset" and not loader.drop_last
    with pytest.raises(ValueError):
        build_data_loader(cfg, "eval")
