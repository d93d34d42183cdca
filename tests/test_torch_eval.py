"""The eval pipeline of the PyTorch port against the JAX package's: the
linear resize, the DTU and Tanks & Temples test sets on the same trees,
the synthetic eval makers, ``eval_file_logger``, ``Checkpointer.load``
with a path, the test CLI end to end, and the port's test and fuse CLIs on
a JPEG tree the port writes. The port runs on the CPU."""

import glob
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from pointmvsnet_tpu.config import get_default_cfg as jget_default_cfg
from pointmvsnet_tpu.dataset import io as jio
from pointmvsnet_tpu.dataset.dtu import DTUTestDataset as JDTUTestDataset
from pointmvsnet_tpu.dataset.preprocess import scale_image as jscale_image
from pointmvsnet_tpu.dataset.synthetic import make_synthetic_dtu as jmake_synthetic_dtu
from pointmvsnet_tpu.dataset.synthetic import make_synthetic_tanks as jmake_synthetic_tanks
from pointmvsnet_tpu.dataset.tanks import TanksDataset as JTanksDataset
from pointmvsnet_tpu.dataset.tanks import pick_shape as jpick_shape
from pointmvsnet_tpu.utils.eval_file_logger import eval_file_logger as jeval_file_logger
from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.dataset import io
from pointmvsnet_tpu_torch.dataset.build import build_data_loader
from pointmvsnet_tpu_torch.dataset.dtu import DTUTestDataset
from pointmvsnet_tpu_torch.dataset.preprocess import resize_image, scale_image
from pointmvsnet_tpu_torch.dataset.synthetic import make_synthetic_dtu, make_synthetic_tanks
from pointmvsnet_tpu_torch.dataset.tanks import TanksDataset, pick_shape
from pointmvsnet_tpu_torch.utils.eval_file_logger import eval_file_logger
from torch_threads import one_torch_thread  # noqa: F401

H, W, V, D = 64, 128, 3, 16
CFG_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs",
                        "dtu_wde3.yaml")
# the decoder's bar against cv2 (tests/test_torch_jpeg.py), in levels
JPEG_BAR = 2


# ------------------------------------------------------------------ resize

@pytest.mark.parametrize("shape", [(640, 800, 3), (37, 53, 3), (101, 67)])
@pytest.mark.parametrize("scale", [0.4, 0.5, 0.8, 1.3])
def test_scale_image_equals_jax_package(shape, scale):
    """Float32 images on a 0-255 range, max |Δ| ≤ 1e-3 against the JAX
    package's cv2.INTER_LINEAR."""
    x = (np.random.RandomState(0).rand(*shape) * 255).astype(np.float32)
    got, want = scale_image(x, scale), jscale_image(x, scale)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-3


def test_linear_resize_uint8_within_one_level_of_cv2():
    x = (np.random.RandomState(1).rand(37, 53, 3) * 255).astype(np.uint8)
    for shape in [(18, 26), (64, 80), (37, 53)]:
        got = resize_image(x, shape, interpolation="linear")
        want = cv2.resize(x, shape[::-1], interpolation=cv2.INTER_LINEAR)
        assert got.dtype == np.uint8 and np.abs(got.astype(int) - want).max() <= 1


# ------------------------------------------------------------------ trees

@pytest.fixture(scope="module")
def train_tree(tmp_path_factory):
    """The JAX package's DTU training release (PNGs, Depths) with scan 1."""
    root = str(tmp_path_factory.mktemp("dtu_train"))
    jmake_synthetic_dtu(root, scans=[1], num_views=V, height=H, width=W, num_depth=D,
                        num_lights=4)
    return root


@pytest.fixture(scope="module")
def eval_trees(tmp_path_factory):
    """The eval release (JPEGs) of scans 1 and 4, 80×160, written by each package."""
    kw = dict(scans=[1, 4], num_views=4, height=80, width=160, num_depth=D, layout="eval")
    roots = {}
    for name, make in (("jax", jmake_synthetic_dtu), ("port", make_synthetic_dtu)):
        roots[name] = str(tmp_path_factory.mktemp(f"dtu_eval_{name}"))
        make(roots[name], **kw)
    return roots


def assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def assert_images_within_decoder_bar(got, want, raw_std):
    """Standardized images whose JPEG decodes may differ by JPEG_BAR levels:
    after norm_image a level is 1/std of the channel, so the bound is
    JPEG_BAR / std plus the mean's shift (the same bound again)."""
    bound = 2 * JPEG_BAR / raw_std + 1e-4
    assert np.abs(got - want).max() <= bound


def test_dtu_test_set_on_training_release(train_tree):
    """Identical PNG inputs, no scaling (box = image size): every key of
    every item bit-equal, GT depth included; each view decoded once."""
    kw = dict(num_view=V, num_virtual_plane=D, interval_scale=1.0, img_height=H,
              img_width=W, scans=[1, 9])
    ds, jds = DTUTestDataset(train_tree, **kw), JDTUTestDataset(train_tree, **kw)
    assert ds.scans == jds.scans == [1] and ds.index == jds.index and len(ds) == V
    for _ in range(2):
        for i in range(len(ds)):
            item = ds[i]
            assert "gt_depth" in item
            assert_items_equal(item, jds[i])
    assert ds._read_image.cache_info().misses == V


def test_dtu_test_set_scaled(train_tree):
    """A box of half the image size: linear downscale by 0.5, then crop to
    base 32; cams bit-equal, images within the resize's float noise."""
    kw = dict(num_view=V, num_virtual_plane=D, img_height=H // 2, img_width=W // 2,
              base=32, light_idx=1)
    item, jitem = DTUTestDataset(train_tree, **kw)[1], JDTUTestDataset(train_tree, **kw)[1]
    assert item["images"].shape == (V, 32, 64, 3)
    np.testing.assert_array_equal(item["cams"], jitem["cams"])
    np.testing.assert_array_equal(item["gt_depth"], jitem["gt_depth"])
    np.testing.assert_allclose(item["images"], jitem["images"], atol=1e-4)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dtu_test_set_on_eval_release(eval_trees, writer):
    """JPEG tree (80×160 → box 64×128: scale 0.8, crop to 64×128): index,
    pairs and cams bit-equal; images within the decoder's bar carried
    through norm_image."""
    root = eval_trees[writer]
    kw = dict(num_view=V, num_virtual_plane=D, img_height=H, img_width=W, scans=[4, 1, 9])
    ds, jds = DTUTestDataset(root, **kw), JDTUTestDataset(root, **kw)
    assert ds.scans == jds.scans == [1, 4] and ds.index == jds.index and len(ds) == 8
    assert ds.pair == jds.pair
    for i in (0, 5):
        item, jitem = ds[i], jds[i]
        assert sorted(item) == sorted(jitem) == ["cams", "images", "ref_view", "scan"]
        for k in ("cams", "ref_view", "scan"):
            np.testing.assert_array_equal(item[k], jitem[k])
        assert item["images"].shape == (V, H, W, 3)
        scan, ref = ds.index[i]
        raw = cv2.imread(os.path.join(root, "Eval", f"scan{scan}", "images", f"{ref:08d}.jpg"))
        assert_images_within_decoder_bar(item["images"], jitem["images"],
                                         raw.reshape(-1, 3).std(0).min())


def test_dtu_test_set_png_fallback_and_mixed_layouts(train_tree, eval_trees, tmp_path):
    root = str(tmp_path / "mixed")
    shutil.copytree(train_tree, root)
    shutil.copytree(os.path.join(eval_trees["port"], "Eval"), os.path.join(root, "Eval"))
    for p in glob.glob(os.path.join(root, "Eval", "scan4", "images", "*.jpg")):
        io.write_png(p[:-4] + ".png", io.read_jpeg(p))
        os.remove(p)
    kw = dict(num_view=V, num_virtual_plane=D, img_height=H, img_width=W, scans=[1, 4])
    ds, jds = DTUTestDataset(root, **kw), JDTUTestDataset(root, **kw)
    assert {s: ds._layout[s][0] for s in ds.scans} == {1: "eval", 4: "eval"}
    assert ds.index == jds.index
    i = ds.index.index((4, 2))
    assert_items_equal(ds[i], jds[i])              # PNG inputs: bit-equal


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_synthetic_eval_makers_agree(eval_trees, tmp_path):
    """Same file names, cams and pair.txt (the pixels differ by design: the
    port renders in numpy, the JAX package with cv2)."""
    names = {k: tree_files(r) for k, r in eval_trees.items()}
    assert names["jax"] == names["port"] and len(names["jax"]) == 2 * (2 * 4 + 1)
    for rel in names["jax"]:
        if rel.endswith(".txt"):
            a, b = (open(os.path.join(r, rel)).read() for r in eval_trees.values())
            assert a == b, rel
    kw = dict(scenes=["Family", "Horse"], num_views=3, height=64, width=96, num_depth=24,
              per_scene={"Horse": {"height": 80, "width": 64, "depth_interval": 1.5}})
    roots = [str(tmp_path / n) for n in ("jax", "port")]
    jmake_synthetic_tanks(roots[0], **kw)
    make_synthetic_tanks(roots[1], **kw)
    files = [tree_files(r) for r in roots]
    assert files[0] == files[1] and len(files[0]) == 2 * (2 * 3 + 1)
    for rel in files[0]:
        if rel.endswith(".txt"):
            assert open(os.path.join(roots[0], rel)).read() == open(os.path.join(roots[1], rel)).read()
        else:
            assert io.read_image(os.path.join(roots[1], rel)).shape == \
                cv2.imread(os.path.join(roots[0], rel)).shape


# ------------------------------------------------------------------ Tanks & Temples

@pytest.mark.parametrize("h,w", [(1080, 1920), (600, 800), (96, 96), (64, 128), (1200, 1600),
                                 (500, 700)])
def test_pick_shape_equals_jax_package(h, w):
    for shapes, base in [([(512, 640), (1024, 1920), (512, 1280)], 64),
                         ([(64, 128), (96, 96)], 32), ([(40, 40), (2000, 2000)], 64)]:
        assert pick_shape(h, w, shapes, base) == jpick_shape(h, w, shapes, base)


@pytest.fixture(scope="module")
def tanks_tree(tmp_path_factory):
    """The JAX package's ragged T&T tree: Family 64×128 with 16 depths,
    Horse 96×96 with 24 depths at interval 1.5."""
    root = str(tmp_path_factory.mktemp("tanks"))
    jmake_synthetic_tanks(root, scenes=["Family", "Horse"], num_views=3, num_depth=16,
                          height=64, width=128,
                          per_scene={"Horse": {"height": 96, "width": 96, "num_depth": 24,
                                               "depth_interval": 1.5}})
    return root


@pytest.mark.parametrize("rescale_depth", [True, False])
@pytest.mark.parametrize("shape_set", [None, [(64, 128), (96, 96)]])
def test_tanks_dataset_equals_jax_package(tanks_tree, rescale_depth, shape_set):
    kw = dict(num_view=3, num_virtual_plane=16, img_height=64, img_width=128, base=32,
              rescale_depth=rescale_depth, shape_set=shape_set)
    ds, jds = TanksDataset(tanks_tree, **kw), JTanksDataset(tanks_tree, **kw)
    assert ds.scenes == jds.scenes == ["Family", "Horse"] and ds.index == jds.index
    for i in range(len(ds)):
        item, jitem = ds[i], jds[i]
        assert sorted(item) == sorted(jitem)
        for k in ("cams", "scan", "ref_view"):
            np.testing.assert_array_equal(item[k], jitem[k])
        scene, ref = ds.index[i]
        raw = cv2.imread(os.path.join(tanks_tree, scene, "images", f"{ref:08d}.jpg"))
        assert_images_within_decoder_bar(item["images"], jitem["images"],
                                         raw.reshape(-1, 3).std(0).min())
    horse = ds[ds.index.index(("Horse", 0))]
    if shape_set:
        assert horse["images"].shape[1:3] == (96, 96)
    assert horse["cams"][0, 1, 3, 2] == (16 if rescale_depth else 24)


# ------------------------------------------------------------------ loader

@pytest.mark.parametrize("dataset,box,batch", [("dtu", (64, 128), 2), ("tanks", (64, 64), 4)])
def test_test_loader_keeps_the_last_batch(request, dataset, box, batch):
    root = request.getfixturevalue("train_tree" if dataset == "dtu" else "tanks_tree")
    cfg = get_default_cfg()
    cfg.merge_from_list(["DATA.TEST.ROOT_DIR", root, "DATA.TEST.DATASET", dataset,
                         "DATA.TEST.NUM_VIEW", "3", "DATA.TEST.NUM_VIRTUAL_PLANE", "16",
                         "DATA.TEST.IMG_HEIGHT", str(box[0]), "DATA.TEST.IMG_WIDTH", str(box[1]),
                         "TEST.BATCH_SIZE", str(batch), "DATA.TEST.SHAPE_SET", f"({box},)"])
    loader = build_data_loader(cfg, "test")
    n = len(loader.dataset)
    assert n % batch and len(loader) == n // batch + 1
    sizes = [b["images"].shape[0] for b in loader]
    assert sizes == [batch] * (n // batch) + [n % batch]


# ------------------------------------------------------------------ eval_file_logger

@pytest.mark.parametrize("final", ["flow2", "coarse"])
def test_eval_file_logger_equals_jax_package(tmp_path, final):
    rng = np.random.RandomState(2)
    b = 2
    batch = {"images": rng.randn(b, V, H, W, 3).astype(np.float32),
             "cams": rng.rand(b, V, 2, 4, 4).astype(np.float32) * 100,
             "scan": np.array([3, 5], np.int32), "ref_view": np.array([0, 7], np.int32)}
    preds = {"coarse_depth_map": rng.rand(b, H // 4, W // 4).astype(np.float32) + 400,
             "coarse_prob_map": rng.rand(b, H // 4, W // 4).astype(np.float32)}
    if final == "flow2":
        preds.update(flow1=rng.rand(b, H // 4, W // 4).astype(np.float32),
                     flow2=rng.rand(b, H // 2, W // 2).astype(np.float32),
                     flow2_input=rng.rand(b, H // 2, W // 2).astype(np.float32))
    for i in range(b):
        eval_file_logger(batch, preds, str(tmp_path / "port"), batch_index=i)
        jeval_file_logger(batch, preds, str(tmp_path / "jax"), batch_index=i)
    files = sorted(os.path.relpath(p, tmp_path / "jax")
                   for p in glob.glob(str(tmp_path / "jax" / "*" / "*")))
    assert files == sorted(os.path.relpath(p, tmp_path / "port")
                           for p in glob.glob(str(tmp_path / "port" / "*" / "*")))
    assert len(files) == b * (6 if final == "flow2" else 4)
    for rel in files:
        a, j = str(tmp_path / "port" / rel), str(tmp_path / "jax" / rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(io.read_png(a), io.read_png(j))
        else:
            assert open(a, "rb").read() == open(j, "rb").read(), rel


# ------------------------------------------------------------------ checkpoint

def test_checkpointer_load_path(tmp_path):
    from pointmvsnet_tpu_torch.models import build_model
    from pointmvsnet_tpu_torch.parallel import TrainState
    from pointmvsnet_tpu_torch.utils.checkpoint import Checkpointer
    from pointmvsnet_tpu_torch.utils.solver import build_optimizer

    cfg = get_default_cfg()
    cfg.MODEL.IMG_BASE_CHANNELS = cfg.MODEL.VOL_BASE_CHANNELS = 4

    def fresh(seed):
        torch.manual_seed(seed)
        model = build_model(cfg, "cpu")
        return TrainState(model, build_optimizer(cfg, dict(model.named_parameters())))

    saved = {}
    ck = Checkpointer(str(tmp_path / "ckpt"))
    for epoch in (0, 3, 1):
        st = fresh(10 + epoch)
        st.step = 100 + epoch
        ck.save(st, epoch)
        saved[epoch] = {k: v.clone() for k, v in st.model.state_dict().items()}
    model_only = str(tmp_path / "model.pt")
    torch.save({"model": saved[1]}, model_only)

    def same(st, sd):
        return all(torch.equal(v, sd[k]) for k, v in st.model.state_dict().items())

    empty = Checkpointer(str(tmp_path / "other"))
    st, nxt = empty.load(fresh(0), path=str(tmp_path / "ckpt"))      # directory: newest
    assert same(st, saved[3]) and st.step == 103 and nxt == 0
    st, _ = empty.load(fresh(0), resume=False, path=ck.path(1))      # one file
    assert same(st, saved[1]) and st.step == 101
    st, _ = empty.load(fresh(0), path=model_only)                    # model only
    assert same(st, saved[1]) and st.step == 0
    st, nxt = empty.load(fresh(0))                                   # nothing to resume
    assert same(st, fresh(0).model.state_dict()) and nxt == 0
    with pytest.raises(FileNotFoundError):
        ck.load(fresh(0), path=str(tmp_path / "other"))


# ------------------------------------------------------------------ test CLI

TEST_OPTS = ["DATA.TEST.NUM_VIEW", str(V), "DATA.TEST.NUM_VIRTUAL_PLANE", str(D),
             "DATA.TEST.IMG_HEIGHT", str(H), "DATA.TEST.IMG_WIDTH", str(W),
             "DATA.TEST.INTERVAL_SCALE", "1.0",
             "MODEL.TEST.IMG_SCALES", "(0.25, 0.5)", "MODEL.TEST.INTER_SCALES", "(0.75, 0.375)"]


@pytest.fixture(scope="module")
def cli_exports(train_tree, tmp_path_factory):
    """The JAX test CLI (jitted) and the port's test CLI on the same PNG
    tree with the same weights, given to each as TEST.WEIGHT: an orbax
    checkpoint of a TrainState of the structure the JAX CLI restores into,
    and the same weights converted by utils/convert.py and saved as a
    model-only .pt. The JAX CLI's own initial weights (create_train_state
    with PRNGKey(RNG_SEED)) give uniform softmaxes at every stage here
    (coarse depth 443.75 everywhere, PointFlow moving nothing), so they
    would not test the values; these are drawn as tests/test_torch_model.py
    draws them (kernels ×2: the flow head's softmax is not flat). The JAX
    CLI builds the TrainState it restores into with an eager ``model.init``
    (about 80 s on the CPU, then overwritten by the restore); it is handed
    the TrainState of the checkpoint instead, of the same structure. The
    port's CLI runs twice: with the ``.pt``, from a state where TF32 is
    allowed (the flags it leaves are returned), and with the orbax
    directory itself as TEST.WEIGHT."""
    import jax.numpy as jnp
    from flax import traverse_util

    from pointmvsnet_tpu import test as jtest
    from pointmvsnet_tpu.dataset.build import build_data_loader as jbuild_data_loader
    from pointmvsnet_tpu.models import build_model as jbuild_model
    from pointmvsnet_tpu.parallel.train_step import TrainState as JTrainState
    from pointmvsnet_tpu.utils.checkpoint import Checkpointer as JCheckpointer
    from pointmvsnet_tpu.utils.solver import build_optimizer as jbuild_optimizer
    from pointmvsnet_tpu_torch import test
    from pointmvsnet_tpu_torch.models import build_model
    from pointmvsnet_tpu_torch.utils.convert import jax_to_torch
    from test_torch_model import KERNEL_SCALE, jax_variables

    work = tmp_path_factory.mktemp("cli")
    opts = ["DATA.TEST.ROOT_DIR", train_tree] + TEST_OPTS
    cfg = jget_default_cfg()
    cfg.merge_from_file(CFG_FILE)
    cfg.merge_from_list(opts)
    model, _, _ = jbuild_model(cfg)
    example = next(iter(jbuild_data_loader(cfg, "test")))
    kw = dict(is_flow=True, img_scales=(0.25,), inter_scales=(0.75,), num_virtual_plane=D)
    flat = jax_variables(model, np.random.RandomState(3), example["images"], example["cams"],
                         kernel_scale=KERNEL_SCALE, **kw)
    tree = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})
    params = tree["params"]
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=tree["batch_stats"],
                         opt_state=jbuild_optimizer(cfg, 1).init(params))
    JCheckpointer(str(work / "jax_ckpt")).save(jstate, 0)

    sd = build_model(get_default_cfg(), "cpu").state_dict()
    converted = jax_to_torch(flat)
    assert set(converted) == {k for k in sd if not k.endswith("num_batches_tracked")}
    sd.update(converted)
    weight = str(work / "weights.pt")
    torch.save({"model": sd}, weight)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PMVS_NO_COMPILE_CACHE", "1")
        mp.setattr(jtest, "create_train_state", lambda *args, **kwargs: jstate)
        jtest.main(["--cfg", CFG_FILE, "OUTPUT_DIR", str(work / "jax"),
                    "TEST.WEIGHT", str(work / "jax_ckpt")] + opts)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.backends.cudnn, "allow_tf32", True)
        mp.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        summary, depth_dir = test.main(["--cfg", CFG_FILE, "--device", "cpu",
                                        "OUTPUT_DIR", str(work / "port"), "TEST.WEIGHT", weight]
                                       + opts)
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    _, orbax_dir = test.main(["--cfg", CFG_FILE, "--device", "cpu", "OUTPUT_DIR",
                              str(work / "port_orbax"), "TEST.WEIGHT", str(work / "jax_ckpt")]
                             + opts)
    return work / "jax" / "depths", depth_dir, summary, orbax_dir, tf32


def test_cli_export_matches_jax_cli(cli_exports):
    """_init and _prob within rtol 1e-4; _flowN within the bars of
    tests/test_full_parity.py (max |Δ| < 0.05, mean < 0.005); cam .txt
    byte-equal; reference PNGs equal."""
    jdir, pdir, summary, _, _ = cli_exports
    jfiles = sorted(os.path.relpath(p, jdir) for p in glob.glob(os.path.join(jdir, "*", "*")))
    assert jfiles == sorted(os.path.relpath(p, pdir) for p in glob.glob(os.path.join(pdir, "*", "*")))
    assert len(jfiles) == V * 6                 # _init, _flow1, _flow2, _prob, .txt, .png
    for rel in jfiles:
        got, want = os.path.join(pdir, rel), os.path.join(jdir, rel)
        if rel.endswith(".txt"):
            assert open(got, "rb").read() == open(want, "rb").read(), rel
        elif rel.endswith(".png"):
            np.testing.assert_array_equal(io.read_png(got), cv2.imread(want)[..., ::-1])
        elif "_flow" in rel:
            d = np.abs(io.load_pfm(got) - jio.load_pfm(want))
            assert d.max() < 0.05 and d.mean() < 0.005, (rel, d.max(), d.mean())
        else:
            np.testing.assert_allclose(io.load_pfm(got), jio.load_pfm(want), rtol=1e-4, err_msg=rel)
    assert {"coarse_loss", "flow1_loss", "flow2_loss"} <= set(summary)
    assert all(np.isfinite(v) for v in summary.values())


def test_cli_flows_move_depth(cli_exports):
    """Guards the flow bars against a flat flow head: each PointFlow
    iteration changes the depth it is given."""
    _, pdir, _, _, _ = cli_exports
    stem = os.path.join(pdir, "scan1", "00000001")
    init, f1, f2 = (io.load_pfm(stem + s) for s in ("_init.pfm", "_flow1.pfm", "_flow2.pfm"))
    assert init.std() > 0.1
    assert np.abs(f1 - resize_image(init, f1.shape)).max() > 1e-3
    assert np.abs(f2 - resize_image(f1, f2.shape)).max() > 1e-3


def test_cli_reads_the_jax_orbax_checkpoint(cli_exports):
    """TEST.WEIGHT at the JAX package's orbax directory exports every file
    bit-equal to the export from the same weights as a .pt (and so within
    the bars of the JAX CLI's export above)."""
    _, pdir, _, odir, _ = cli_exports
    files = sorted(os.path.relpath(p, pdir) for p in glob.glob(os.path.join(pdir, "*", "*")))
    assert files and files == sorted(os.path.relpath(p, odir)
                                     for p in glob.glob(os.path.join(odir, "*", "*")))
    for rel in files:
        with open(os.path.join(pdir, rel), "rb") as a, open(os.path.join(odir, rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_entry_points_turn_tf32_off(cli_exports, monkeypatch):
    """test.test (in cli_exports) and Predictor leave cuDNN's and cuBLAS's
    TF32 off, from a state that allowed it, on any device."""
    from pointmvsnet_tpu_torch.predictor import Predictor

    assert cli_exports[4] == (False, False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    cfg = get_default_cfg()
    cfg.MODEL.IMG_BASE_CHANNELS = cfg.MODEL.VOL_BASE_CHANNELS = 4
    Predictor(cfg, device="cpu")
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("key", ["PARALLEL.BAND", "PARALLEL.VIEW"])
def test_cli_refuses_parallel_eval(train_tree, tmp_path, key):
    from pointmvsnet_tpu_torch import test
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        test.main(["--device", "cpu", "OUTPUT_DIR", str(tmp_path), key, "2",
                   "DATA.TEST.ROOT_DIR", train_tree] + TEST_OPTS)


def test_cli_defaults_to_cuda(train_tree, tmp_path, monkeypatch):
    from pointmvsnet_tpu_torch import test
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        test.main(["OUTPUT_DIR", str(tmp_path), "DATA.TEST.ROOT_DIR", train_tree] + TEST_OPTS)


def test_pipeline_on_a_jpeg_tree(tmp_path):
    """The port alone: its eval-release JPEG tree, its test CLI with seeded
    weights, then its fuse CLI, both on the CPU."""
    from pointmvsnet_tpu_torch import fuse, test
    from pointmvsnet_tpu_torch.postprocess import read_ply

    root = str(tmp_path / "tree")
    make_synthetic_dtu(root, scans=[1], num_views=V, height=H, width=W, num_depth=D,
                       layout="eval")
    out = str(tmp_path / "out")
    summary, depth_dir = test.main(["--device", "cpu", "OUTPUT_DIR", out,
                                    "DATA.TEST.ROOT_DIR", root, "MODEL.IMG_BASE_CHANNELS", "4",
                                    "MODEL.VOL_BASE_CHANNELS", "4"] + TEST_OPTS)
    assert len(glob.glob(os.path.join(depth_dir, "scan1", "*_flow2.pfm"))) == V
    assert summary["maps"] == V and summary["maps_per_s_after_first"] > 0
    res = fuse.main(["--depth_dir", depth_dir, "--out", str(tmp_path / "clouds"),
                     "--device", "cpu", "--prob_threshold", "0", "--min_views", "1"])
    pts, cols = read_ply(res["scan1"]["ply"])
    assert res["scan1"]["backend"] == "torch" and len(pts) == res["scan1"]["n_points"] > 0
    assert cols is not None and np.isfinite(pts).all()
    assert os.path.isfile(tmp_path / "clouds" / "fusion_results.json")
