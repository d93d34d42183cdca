"""The Tanks & Temples export of the port's test CLI against the JAX
package's test CLI: one tiny ragged tree (two scenes at two resolutions,
each with a cam ``num_depth`` other than the model's D), ``SHAPE_SET``
picking a shape per scene, ``RESCALE_DEPTH`` folding each file's depth
count into D, the same weights through ``TEST.WEIGHT``. The port runs on
the CPU; the card's T&T export at 1920×1080 is ``chip_smoke.py`` phase
``tanks``."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pointmvsnet_tpu.config import get_default_cfg as jget_default_cfg
from pointmvsnet_tpu.dataset import io as jio
from pointmvsnet_tpu.dataset.synthetic import make_synthetic_tanks as jmake_synthetic_tanks
from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.dataset import io
from pointmvsnet_tpu_torch.models import build_model
from pointmvsnet_tpu_torch.utils.convert import jax_to_torch
from test_torch_model import KERNEL_SCALE, jax_variables
from torch_threads import one_torch_thread  # noqa: F401

CFG_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs",
                        "tanks.yaml")
V, D = 3, 16
# scene → (height, width, cam num_depth, depth interval) of its frames, and
# the member of SHAPE_SET that pick_shape gives it
SCENES = {"Family": ((64, 128, 32, 2.5), (64, 128)),
          "Horse": ((96, 96, 24, 1.5), (64, 64))}
SHAPE_SET = "((64, 128), (64, 64))"
OPTS = ["DATA.TEST.NUM_VIEW", str(V), "DATA.TEST.NUM_VIRTUAL_PLANE", str(D),
        "DATA.TEST.SHAPE_SET", SHAPE_SET,
        "MODEL.TEST.IMG_SCALES", "(0.25, 0.5)", "MODEL.TEST.INTER_SCALES", "(0.75, 0.375)"]


@pytest.fixture(scope="module")
def tanks_exports(tmp_path_factory):
    """Both test CLIs on the JAX package's ragged tree, its JPEGs rewritten
    as PNGs (both packages read those bit-equal; their JPEG decoders may
    differ by a level). The weights are drawn as tests/test_torch_eval.py's
    cli_exports draws them (kernels ×2) and given to the JAX CLI as an
    orbax checkpoint, whose TrainState it is handed instead of building its
    own with an eager ``model.init``, and to the port's as a ``.pt``. → the
    JAX and the port's depth directories."""
    from pointmvsnet_tpu import test as jtest
    from pointmvsnet_tpu.dataset.build import build_data_loader as jbuild_data_loader
    from pointmvsnet_tpu.models import build_model as jbuild_model
    from pointmvsnet_tpu.parallel.train_step import TrainState as JTrainState
    from pointmvsnet_tpu.utils.checkpoint import Checkpointer as JCheckpointer
    from pointmvsnet_tpu.utils.solver import build_optimizer as jbuild_optimizer
    from pointmvsnet_tpu_torch import test

    work = tmp_path_factory.mktemp("tanks_cli")
    root = str(work / "tree")
    (fh, fw, fnd, fdi), _ = SCENES["Family"]
    jmake_synthetic_tanks(root, scenes=list(SCENES), num_views=V, height=fh, width=fw,
                          num_depth=fnd, depth_interval=fdi,
                          per_scene={s: dict(height=h, width=w, num_depth=nd, depth_interval=di)
                                     for s, ((h, w, nd, di), _) in SCENES.items()})
    for p in glob.glob(os.path.join(root, "*", "images", "*.jpg")):
        io.write_png(p[:-4] + ".png", io.read_jpeg(p))
        os.remove(p)
    opts = ["DATA.TEST.ROOT_DIR", root] + OPTS

    cfg = jget_default_cfg()
    cfg.merge_from_file(CFG_FILE)
    cfg.merge_from_list(opts)
    model, _, _ = jbuild_model(cfg)
    example = next(iter(jbuild_data_loader(cfg, "test")))
    flat = jax_variables(model, np.random.RandomState(3), example["images"], example["cams"],
                         kernel_scale=KERNEL_SCALE, is_flow=True, img_scales=(0.25,),
                         inter_scales=(0.75,), num_virtual_plane=D)
    tree = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})
    params = tree["params"]
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=tree["batch_stats"],
                         opt_state=jbuild_optimizer(cfg, 1).init(params))
    JCheckpointer(str(work / "jax_ckpt")).save(jstate, 0)
    sd = build_model(get_default_cfg(), "cpu").state_dict()
    sd.update(jax_to_torch(flat))
    weight = str(work / "weights.pt")
    torch.save({"model": sd}, weight)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PMVS_NO_COMPILE_CACHE", "1")
        mp.setattr(jtest, "create_train_state", lambda *args, **kwargs: jstate)
        jtest.main(["--cfg", CFG_FILE, "OUTPUT_DIR", str(work / "jax"),
                    "TEST.WEIGHT", str(work / "jax_ckpt")] + opts)
    summary, depth_dir = test.main(["--cfg", CFG_FILE, "--device", "cpu", "OUTPUT_DIR",
                                    str(work / "port"), "TEST.WEIGHT", weight] + opts)
    assert summary["maps"] == V * len(SCENES)
    return str(work / "jax" / "depths"), depth_dir


def files_of(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "*", "*")))


def test_tanks_cli_writes_the_same_files(tanks_exports):
    jdir, pdir = tanks_exports
    files = files_of(jdir)
    assert files == files_of(pdir)
    assert len(files) == len(SCENES) * V * 6     # _init, _flow1, _flow2, _prob, .txt, .png


@pytest.mark.parametrize("scene", list(SCENES))
def test_tanks_cli_picks_each_scene_shape(tanks_exports, scene):
    """Both CLIs export the scene at the shape pick_shape gives it (the
    reference image at the input size, flow2 at half of it), and its
    cameras with the depth count folded into D over the file's range."""
    (_, _, nd, di), (th, tw) = SCENES[scene]
    scan = f"scan{list(SCENES).index(scene)}"
    for root, load_cam in ((tanks_exports[0], jio.load_cam), (tanks_exports[1], io.load_cam)):
        for v in range(V):
            stem = os.path.join(root, scan, f"{v:08d}")
            assert io.read_png(stem + ".png").shape == (th, tw, 3)
            assert io.load_pfm(stem + "_flow2.pfm").shape == (th // 2, tw // 2)
            cam = load_cam(stem + ".txt")
            assert cam[1, 3, 2] == D
            np.testing.assert_allclose(cam[1, 3, 1], di * (nd - 1) / (D - 1), rtol=1e-5)


def test_tanks_cli_export_matches_jax_cli(tanks_exports):
    """As tests/test_torch_eval.py's DTU export: _init and _prob within
    rtol 1e-4; _flowN within the bars of tests/test_full_parity.py (max
    |Δ| < 0.05, mean < 0.005); cam .txt byte-equal; reference PNGs equal."""
    jdir, pdir = tanks_exports
    for rel in files_of(jdir):
        got, want = os.path.join(pdir, rel), os.path.join(jdir, rel)
        if rel.endswith(".txt"):
            assert open(got, "rb").read() == open(want, "rb").read(), rel
        elif rel.endswith(".png"):
            np.testing.assert_array_equal(io.read_png(got), io.read_png(want), err_msg=rel)
        elif "_flow" in rel:
            d = np.abs(io.load_pfm(got) - jio.load_pfm(want))
            assert d.max() < 0.05 and d.mean() < 0.005, (rel, d.max(), d.mean())
        else:
            np.testing.assert_allclose(io.load_pfm(got), jio.load_pfm(want), rtol=1e-4,
                                       err_msg=rel)
