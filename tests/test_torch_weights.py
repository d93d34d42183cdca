"""Weights the JAX package loads, loaded by the PyTorch port.

- ``utils/zstd.py`` against ``zstandard`` (the test's oracle only): frames
  at levels -5, 1, 3 and 19 of 0, 1, 4 KiB and 300 KiB (multi-block) of
  random float32 and of repetitive bytes, with and without a checksum;
  concatenated, skippable and streamed frames; frames with more than
  0x7F00 sequences in a block and with RLE literals; a bad checksum, a
  dictionary id and a truncated frame raise.
- ``utils/orbax_reader.py::read_orbax`` against orbax's own restore, leaf
  by leaf (dtype, shape, bytes), on TrainStates the JAX package's
  ``Checkpointer`` writes at every path form it accepts, on a tree of
  every dtype the reader supports, and on a store of b-tree interior
  nodes, versions and multi-chunk arrays written by tensorstore; and once
  in a process where ``zstandard``, ``orbax``, ``tensorstore`` and
  ``jax`` cannot be imported.
- ``utils/torch_convert.py`` against the JAX package's converter carried
  across by ``utils/convert.py::jax_to_torch``, bit-equal on every key
  of ``TorchPointMVSNet()``'s full state dict, with and without a
  ``name_map``; its CLI's ``.pt`` read by ``Checkpointer.load`` and
  ``Predictor``.
- The committed fixture ``tests/data/orbax_tiny/``: a TrainState the JAX
  package's ``Checkpointer`` wrote (image and volume base widths 2, f32),
  and ``expected.npz`` beside it, the JAX package's forward (two
  PointFlow iterations) on those weights for the port's seeded scene
  (``make_scene_batch``; its seed, sizes and scales are stored in the
  file). ``chip_smoke.py``'s ``weights`` phase
  runs the port on the card against it. ``write_fixture`` rewrites both;
  it is run only by hand, from the repository's root:

      python -c "import sys; sys.path[:0] = ['tests']; import conftest, \\
          test_torch_weights as t; t.write_fixture()"
"""

import os
import pickle
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
import zstandard

from pointmvsnet_tpu.config import get_default_cfg as jget_default_cfg
from pointmvsnet_tpu.models import build_model as jbuild_model
from pointmvsnet_tpu.parallel.train_step import TrainState as JTrainState
from pointmvsnet_tpu.utils.checkpoint import Checkpointer as JCheckpointer
from pointmvsnet_tpu.utils.solver import build_optimizer as jbuild_optimizer
from pointmvsnet_tpu.utils.torch_convert import convert_state_dict as jconvert_state_dict
from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
from pointmvsnet_tpu_torch.models import build_model
from pointmvsnet_tpu_torch.utils import torch_convert, zstd
from pointmvsnet_tpu_torch.utils.convert import jax_to_torch
from pointmvsnet_tpu_torch.utils.orbax_reader import read_orbax, resolve
from torch_mirror import TorchPointMVSNet
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "orbax_tiny")
EXPECTED = os.path.join(FIXTURE, "expected.npz")
CFG_FILE = os.path.join(ROOT, "configs", "dtu_wde3.yaml")
# two PointFlow iterations (the flow weights are shared by every iteration;
# a third would add 12 s of JAX compile to the test)
SCALES, INTER = (0.25, 0.5), (0.75, 0.375)
STAGES = ("coarse_depth_map", "coarse_prob_map", "flow1", "flow2")


# ------------------------------------------------------------------ zstd

def _bytes(kind, n):
    if kind == "f32":
        return np.random.RandomState(n).rand(-(-n // 4)).astype(np.float32).tobytes()[:n]
    return (b"pointmvsnet " * (n // 12 + 1))[:n]


def _frame(level, n, kind, checksum):
    src = _bytes(kind, n)
    return src, zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(src)


def _special(name):
    """Frames of the paths the level / size / data matrix may not reach."""
    if name == "concatenated + skippable":
        a, fa = _frame(3, 5000, "f32", True)
        b, fb = _frame(19, 70000, "repetitive", False)
        skip = (0x184D2A53).to_bytes(4, "little") + (7).to_bytes(4, "little") + b"skipped"
        return a + b, fa + skip + fb + skip
    if name == "streamed":          # no content size, a window descriptor, several blocks
        src = _bytes("f32", 300 * 1024)
        c = zstandard.ZstdCompressor(level=3, write_checksum=True, write_content_size=False)
        w = c.compressobj()
        return src, w.compress(src[:100000]) + w.compress(src[100000:]) + w.flush()
    if name == "many sequences":    # > 0x7F00 sequences in a block
        tokens = np.random.RandomState(1).choice([b"abcd", b"efgh", b"ijkl", b"mnop"], 75000)
        src = b"".join(tokens)
        return src, zstandard.ZstdCompressor(level=1).compress(src)
    # RLE literals: single-segment frame, one compressed block of 20 RLE
    # literals and no sequences
    block = bytes([1 | (20 << 3), ord("q"), 0])
    frame = (zstd.MAGIC.to_bytes(4, "little") + bytes([0x20, 20])
             + (1 | (2 << 1) | (len(block) << 3)).to_bytes(3, "little") + block)
    assert zstandard.ZstdDecompressor().decompress(frame) == b"q" * 20   # a valid frame
    return b"q" * 20, frame


ZSTD_CASES = ([(lv, n, kind, ck) for lv in (-5, 1, 3, 19) for n in (0, 1, 4096, 300 * 1024)
               for kind in ("f32", "repetitive") for ck in (False, True)]
              + ["concatenated + skippable", "streamed", "many sequences", "RLE literals"])


@pytest.mark.parametrize("case", ZSTD_CASES, ids=str)
def test_zstd_decodes_what_zstandard_writes(case):
    src, frame = _special(case) if isinstance(case, str) else _frame(*case)
    assert zstd.decompress(frame) == src


def test_zstd_rejects_bad_frames():
    src, frame = _frame(3, 4096, "f32", True)
    bad = bytearray(frame)
    bad[-1] ^= 1
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(bad))
    samples = [f'{{"k{i}": [{3 * i}, {7 * i}, "abc{i % 13}"]}}'.encode() * 3 for i in range(400)]
    d = zstandard.train_dictionary(1024, samples)
    with pytest.raises(ValueError, match="dictionar"):
        zstd.decompress(zstandard.ZstdCompressor(dict_data=d).compress(samples[5]))
    with pytest.raises(ValueError):
        zstd.decompress(frame[:-40])


# ------------------------------------------------------------------ orbax

def _flat_restore(tree, prefix=""):
    """orbax's restored tree → {"a/b/c": ndarray} (None leaves dropped)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {} if tree is None else {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat_restore(v, f"{prefix}{k}/"))
    return out


def assert_same_as_orbax(got, path):
    want = _flat_restore(ocp.StandardCheckpointer().restore(resolve(path)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if w.dtype == jnp.bfloat16:          # numpy has no bfloat16: widened exactly
            w = w.astype(np.float32)
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


def _fixture_cfg(get_cfg, widths=(2, 2)):
    cfg = get_cfg()
    cfg.MODEL.IMG_BASE_CHANNELS, cfg.MODEL.VOL_BASE_CHANNELS = (int(w) for w in widths)
    return cfg


def _train_state(cfg, images, cams, step=0):
    """A TrainState of the JAX package's structure at ``cfg``'s widths, with
    the weights tests/test_torch_model.py draws (kernels ×2)."""
    from test_torch_model import KERNEL_SCALE, jax_variables, unflatten

    model, _, _ = jbuild_model(cfg)
    flat = jax_variables(model, np.random.RandomState(3), jnp.asarray(images[:, :, :64, :64]),
                         jnp.asarray(cams), is_flow=True, img_scales=(0.25,),
                         inter_scales=(0.75,), num_virtual_plane=8, kernel_scale=KERNEL_SCALE)
    tree = unflatten(flat)
    state = JTrainState(step=jnp.asarray(step, jnp.int32), params=tree["params"],
                        batch_stats=tree["batch_stats"],
                        opt_state=jbuild_optimizer(cfg, 1).init(tree["params"]))
    return model, state


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A manager root the JAX package's Checkpointer wrote: epochs 1 and 2
    of a TrainState with the committed fixture's weights (which saves the
    5 s of tracing that drawing them takes)."""
    restored = ocp.StandardCheckpointer().restore(resolve(FIXTURE))
    params = restored["params"]
    cfg = _fixture_cfg(jget_default_cfg)
    root = str(tmp_path_factory.mktemp("orbax") / "ckpt")
    ck = JCheckpointer(root)
    for epoch in (1, 2):
        ck.save(JTrainState(step=jnp.asarray(10 * epoch, jnp.int32), params=params,
                            batch_stats=restored["batch_stats"],
                            opt_state=jbuild_optimizer(cfg, 1).init(params)), epoch)
    ck.close()
    return root


@pytest.mark.parametrize("form", ["manager root", "step", "item"])
def test_read_orbax_equals_orbax_restore(jax_ckpt, form):
    path = {"manager root": jax_ckpt, "step": os.path.join(jax_ckpt, "2"),
            "item": os.path.join(jax_ckpt, "2", "default")}[form]
    got = read_orbax(path)
    assert int(got["step"]) == 20 and got["step"].dtype == np.int32
    assert_same_as_orbax(got, path)
    weights = read_orbax(path, keys=("params/", "batch_stats/"))
    assert set(weights) == {k for k in got if k.startswith(("params/", "batch_stats/"))}


def test_read_orbax_every_dtype(tmp_path):
    """The JAX package's bfloat16 TrainState keeps f32 parameters (flax's
    param_dtype) and an int32 step, so a tree of its own holds the other
    dtypes the reader supports."""
    rng = np.random.RandomState(0)
    tree = {"step": np.int32(7),
            "bf16": jnp.asarray(rng.randn(3, 5), jnp.bfloat16),
            "f16": rng.randn(4).astype(np.float16),
            "i64": np.arange(-3, 3, dtype=np.int64).reshape(2, 3),
            "mask": rng.rand(6) > 0.5,
            "params": {"w": rng.randn(300, 400).astype(np.float32)}}
    ck = ocp.StandardCheckpointer()
    ck.save(str(tmp_path / "item"), tree)
    ck.wait_until_finished()
    got = read_orbax(str(tmp_path / "item"))
    assert got["i64"].dtype == np.int64 and got["bf16"].dtype == np.float32
    assert_same_as_orbax(got, str(tmp_path / "item"))


def test_read_orbax_on_tensorstore_layouts(tmp_path):
    """An OCDBT store whose b-tree has interior nodes and whose manifest has
    many versions, holding a zarr array of 3×4 chunks with chunks left
    unwritten (fill_value), written by tensorstore itself."""
    import json

    import tensorstore as ts

    root = str(tmp_path / "item")
    kv = {"driver": "ocdbt", "base": f"file://{root}",
          "config": {"max_decoded_node_bytes": 256, "max_inline_value_bytes": 32,
                     "version_tree_arity_log2": 1}}
    arr = ts.open({"driver": "zarr", "kvstore": dict(kv, path="params.w/"),
                   "metadata": {"shape": [10, 13], "chunks": [4, 5], "dtype": "<f4",
                                "fill_value": 1.5, "compressor": {"id": "zstd", "level": 3}}},
                  create=True).result()
    rng = np.random.RandomState(0)
    want = np.full((10, 13), 1.5, np.float32)
    for r0, c0 in [(0, 0), (4, 5), (8, 10), (0, 10)]:            # one write, one version each
        block = rng.randn(2, 3).astype(np.float32)
        arr[r0:r0 + 2, c0:c0 + 3] = block
        want[r0:r0 + 2, c0:c0 + 3] = block
    store = ts.KvStore.open(kv).result()
    for i in range(60):                                          # keys enough for interior nodes
        store.write(f"other.{i:03d}".encode(), rng.bytes(rng.randint(1, 64))).result()
    meta = {"tree_metadata": {"('params', 'w')": {
        "key_metadata": [{"key": "params", "key_type": 2}, {"key": "w", "key_type": 2}],
        "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}},
        "use_ocdbt": True, "use_zarr3": False}
    with open(os.path.join(root, "_METADATA"), "w") as f:
        json.dump(meta, f)
    got = read_orbax(root)["params/w"]
    assert got.dtype == np.float32 and np.array_equal(got, want)
    np.testing.assert_array_equal(got, arr.read().result())


def test_read_orbax_needs_no_zstd_module(jax_ckpt, tmp_path):
    out = str(tmp_path / "arrays.pkl")
    code = ("import sys\n"
            "for m in ('zstandard', 'orbax', 'orbax.checkpoint', 'tensorstore', 'jax'):\n"
            "    sys.modules[m] = None\n"
            "import pickle\n"
            "from pointmvsnet_tpu_torch.utils.orbax_reader import read_orbax\n"
            f"pickle.dump(read_orbax({jax_ckpt!r}), open({out!r}, 'wb'))\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=300,
                   env=dict(os.environ, PYTHONPATH=ROOT))
    with open(out, "rb") as f:
        got = pickle.load(f)
    want = read_orbax(jax_ckpt)
    assert sorted(got) == sorted(want)
    assert all(got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
               for k in want)


def test_read_orbax_rejects_what_it_cannot_read(jax_ckpt, tmp_path):
    import json

    item = str(tmp_path / "item")
    shutil.copytree(os.path.join(jax_ckpt, "1", "default"), item)
    meta_path = os.path.join(item, "_METADATA")
    with open(meta_path) as f:
        meta = json.load(f)
    with open(meta_path, "w") as f:
        json.dump(dict(meta, use_zarr3=True), f)
    with pytest.raises(ValueError, match="zarr"):
        read_orbax(item)
    with pytest.raises(ValueError, match="_METADATA"):
        read_orbax(str(tmp_path))


# ------------------------------------------------------------------ .pth

@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """The mirror's full default state dict, BN statistics not an identity,
    saved as the reference's DataParallel checkpoints are."""
    torch.manual_seed(7)
    tm = TorchPointMVSNet()
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(torch.from_numpy(rng.randn(*m.running_mean.shape) * 0.3))
                m.running_var.copy_(torch.from_numpy(0.5 + rng.rand(*m.running_var.shape)))
    path = str(tmp_path_factory.mktemp("pth") / "model.pth")
    torch.save({"model": {"module." + k: v for k, v in tm.state_dict().items()}}, path)
    return path


@pytest.fixture(scope="module")
def jax_template():
    """The JAX package's variables at the default widths, shapes only."""
    images, cams, _ = make_scene_batch(1, 3, 64, 64, 8)
    model, _, _ = jbuild_model(jget_default_cfg())
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(cams), is_flow=True,
        img_scales=(0.25,), inter_scales=(0.75,), num_virtual_plane=8))


def _jax_conversion(sd, template, name_map=None):
    from flax import traverse_util

    conv = jconvert_state_dict(sd, template, name_map)
    return jax_to_torch({f"{c}/{'/'.join(k)}": np.asarray(v) for c in conv
                         for k, v in traverse_util.flatten_dict(conv[c]).items()})


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k].numpy().view(np.uint32), want[k].numpy().view(np.uint32)), k


def test_pth_conversion_equals_jax_package(reference_pth, jax_template):
    sd = torch_convert.load_pth(reference_pth)
    assert not any(k.startswith("module.") for k in sd)
    model = build_model(get_default_cfg(), "cpu")
    got = torch_convert.convert_state_dict(sd, model)
    want = _jax_conversion(sd, jax_template)
    _assert_bit_equal(got, want)
    assert set(got) == {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}


def test_pth_conversion_name_map(reference_pth, jax_template):
    """Two 3×3 convs of one ImageConv stage, swapped by name in both
    converters: equal to each other, and not to the greedy assignment."""
    sd = torch_convert.load_pth(reference_pth)
    model = build_model(get_default_cfg(), "cpu")
    a, b = "img_conv.blocks.3.conv.weight", "img_conv.blocks.4.conv.weight"
    ta, tb = "img_conv.net1.3.weight", "img_conv.net1.6.weight"
    assert sd[ta].shape == sd[tb].shape and not np.array_equal(sd[ta], sd[tb])
    got = torch_convert.convert_state_dict(sd, model, {a: tb, b: ta})
    want = _jax_conversion(sd, jax_template,
                           {"params/img_conv/ConvBlock_3/Conv_0/kernel": tb,
                            "params/img_conv/ConvBlock_4/Conv_0/kernel": ta})
    _assert_bit_equal(got, want)
    greedy = torch_convert.convert_state_dict(sd, model)
    assert torch.equal(got[a], greedy[b]) and torch.equal(got[b], greedy[a])


def test_pth_conversion_unmatched_raises(reference_pth):
    sd = torch_convert.load_pth(reference_pth)
    del sd["vol_conv.final.weight"]
    with pytest.raises(ValueError, match="unmatched"):
        torch_convert.convert_state_dict(sd, build_model(get_default_cfg(), "cpu"))


def test_convert_cli_round_trip(reference_pth, tmp_path):
    from pointmvsnet_tpu_torch.parallel import TrainState
    from pointmvsnet_tpu_torch.predictor import Predictor
    from pointmvsnet_tpu_torch.utils.checkpoint import Checkpointer
    from pointmvsnet_tpu_torch.utils.solver import build_optimizer

    out = str(tmp_path / "weights.pt")
    torch_convert.main(["--pth", reference_pth, "--cfg", CFG_FILE, "--out", out])
    cfg = get_default_cfg()
    cfg.merge_from_file(CFG_FILE)
    want = torch_convert.convert_state_dict(torch_convert.load_pth(reference_pth),
                                            build_model(cfg, "cpu"))
    model = build_model(cfg, "cpu")
    state, epoch = Checkpointer(str(tmp_path / "unused")).load(
        TrainState(model, build_optimizer(cfg, dict(model.named_parameters()))), path=out)
    assert epoch == 0
    for sd in (state.model.state_dict(),
               Predictor(cfg, weight_path=out, device="cpu").model.state_dict()):
        assert all(torch.equal(sd[k], v) for k, v in want.items())


# ------------------------------------------------------------------ the fixture

def _jax_forward(model, variables, images, cams, d):
    fn = jax.jit(lambda v, im, cm: model.apply(v, im, cm, is_flow=True, img_scales=SCALES,
                                               inter_scales=INTER, num_virtual_plane=d))
    out = fn(variables, jnp.asarray(images), jnp.asarray(cams))
    return {k: np.asarray(out[k], np.float32) for k in STAGES}


def write_fixture():
    """Rewrite tests/data/orbax_tiny/ and its expected.npz (by hand only)."""
    seed, (v, h, w, d) = 4, (3, 64, 128, 16)
    images, cams, _ = make_scene_batch(1, v, h, w, d, seed=seed)
    cfg = _fixture_cfg(jget_default_cfg)
    model, state = _train_state(cfg, images, cams, step=300)
    shutil.rmtree(FIXTURE, ignore_errors=True)
    ck = JCheckpointer(FIXTURE)
    ck.save(state, 3)
    ck.close()
    out = _jax_forward(model, {"params": state.params, "batch_stats": state.batch_stats},
                       images, cams, d)
    np.savez(EXPECTED, seed=seed, shape=[v, h, w, d], widths=[2, 2], scales=SCALES,
             inter_scales=INTER, **out)


@pytest.fixture(scope="module")
def fixture_expected():
    e = np.load(EXPECTED)
    v, h, w, d = (int(x) for x in e["shape"])
    images, cams, _ = make_scene_batch(1, v, h, w, d, seed=int(e["seed"]))
    return e, images, cams, d


def test_fixture_is_what_orbax_restores():
    assert_same_as_orbax(read_orbax(FIXTURE), FIXTURE)


def test_fixture_expected_is_the_jax_forward(fixture_expected):
    e, images, cams, d = fixture_expected
    restored = ocp.StandardCheckpointer().restore(resolve(FIXTURE))
    model, _, _ = jbuild_model(_fixture_cfg(jget_default_cfg, e["widths"]))
    out = _jax_forward(model, {"params": restored["params"],
                               "batch_stats": restored["batch_stats"]}, images, cams, d)
    for k in STAGES:
        np.testing.assert_allclose(out[k], e[k], rtol=1e-5, err_msg=k)


def test_port_on_fixture_matches_expected(fixture_expected):
    """The port on the CPU from the orbax directory, against the JAX
    package's depth: the bars of tests/test_full_parity.py."""
    from pointmvsnet_tpu_torch.predictor import Predictor

    e, images, cams, d = fixture_expected
    cfg = _fixture_cfg(get_default_cfg, e["widths"])
    cfg.MODEL.TEST.IMG_SCALES, cfg.MODEL.TEST.INTER_SCALES = SCALES, INTER
    cfg.DATA.TEST.NUM_VIRTUAL_PLANE = d
    out = Predictor(cfg, weight_path=FIXTURE, device="cpu", normalize=False)(images[0], cams[0])
    for k in ("coarse_depth_map", "flow1", "flow2"):
        diff = np.abs(out[k] - e[k][0])
        assert diff.max() < 0.05 and diff.mean() < 0.005, (k, diff.max(), diff.mean())
    assert np.abs(out["coarse_prob_map"] - e["coarse_prob_map"][0]).max() < 0.02
    for it in (1, 2):                  # the flows move the depth: the bars are not vacuous
        assert np.abs(out[f"flow{it}"] - out[f"flow{it}_input"]).max() > 1e-3
