"""Model modules and the whole eval slice of the PyTorch port vs the JAX
package, with the JAX variables converted by ``utils/convert.py``. The
port runs on the CPU, i.e. through the plain versions of its kernels."""

import flax.traverse_util as traverse_util
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointmvsnet_tpu.models.image_conv import ImageConv as JImageConv
from pointmvsnet_tpu.models.pointmvsnet import PointMVSNet as JPointMVSNet
from pointmvsnet_tpu.models.volume_conv import VolumeConv as JVolumeConv
from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
from pointmvsnet_tpu_torch.models import build_model
from pointmvsnet_tpu_torch.models.image_conv import ImageConv
from pointmvsnet_tpu_torch.models.pointmvsnet import PointMVSNet
from pointmvsnet_tpu_torch.models.volume_conv import VolumeConv
from pointmvsnet_tpu_torch.utils.convert import jax_to_torch, load_jax_variables
from torch_threads import one_torch_thread  # noqa: F401


def jax_variables(module, rng, *args, kernel_scale=1.0, **kwargs):
    """Flat variables of a flax ``module`` made with numpy, without running
    its init: kernels uniform in ±1/√fan_in (flax's conv_kernel_init) times
    ``kernel_scale``, biases zero, BN / GN affine and statistics random so
    that eval BN is no identity."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    out = {}
    for k, s in flatten(shapes).items():
        shape = s.shape
        if k.endswith("/kernel"):
            bound = float(np.prod(shape[:-1])) ** -0.5
            v = rng.uniform(-bound, bound, shape) * kernel_scale
        elif k.endswith("/mean") or ("Norm" in k and k.endswith("/bias")):
            v = rng.randn(*shape) * 0.3
        elif k.endswith("/var") or k.endswith("/scale"):
            v = 0.5 + rng.rand(*shape)
        else:
            v = np.zeros(shape)
        out[k] = v.astype(np.float32)
    return out


def flatten(variables, prefix=""):
    return {f"{coll}/{prefix}{k}": v for coll in variables
            for k, v in traverse_util.flatten_dict(variables[coll], sep="/").items()}


def unflatten(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


def load_submodule(mod, flat, torch_prefix):
    sd = {k.removeprefix(torch_prefix): v for k, v in jax_to_torch(flat).items()}
    res = mod.load_state_dict(sd, strict=False)
    assert not res.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in res.missing_keys)
    return mod.eval()


# ------------------------------------------------------------ conv modules
# atol 1e-4: eleven (ImageConv) / ten (VolumeConv) stacked f32 convs

@pytest.mark.parametrize("norm", ["bn", "gn"])
def test_image_conv(norm):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 48, 3).astype(np.float32)
    jm = JImageConv(4, norm)
    var = jax_variables(jm, rng, jnp.asarray(x))
    want = jax.jit(jm.apply)(unflatten(var), jnp.asarray(x))
    flat = {k.replace("/", "/img_conv/", 1): v for k, v in var.items()}
    tm = load_submodule(ImageConv(4, norm), flat, "img_conv.")
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("norm", ["bn", "gn"])
def test_volume_conv(norm):
    rng = np.random.RandomState(1)
    x = rng.rand(1, 8, 8, 16, 16).astype(np.float32)
    jm = JVolumeConv(4, norm)
    var = jax_variables(jm, rng, jnp.asarray(x))
    want = jax.jit(jm.apply)(unflatten(var), jnp.asarray(x))
    flat = {k.replace("/", "/vol_conv/", 1): v for k, v in var.items()}
    tm = load_submodule(VolumeConv(4, 16, norm), flat, "vol_conv.")
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


# ------------------------------------------------------------ build_model

@pytest.mark.parametrize("key,value", [
    ("KNN_IMPL", "pallas"), ("KNN_IMPL", "xla"), ("FLOW_FETCH", "table"),
    ("COARSE_FETCH", "take"), ("FLOW_MOMENTS", "False"), ("FLOW_MOMENTS", "off"),
    ("FLOW_MOMENTS", False), ("FLOW_SRC_DTYPE", "bfloat16"), ("REMAT", True)])
def test_build_model_rejects_tpu_knobs(key, value):
    cfg = get_default_cfg()
    cfg.MODEL[key] = value
    with pytest.raises(ValueError):
        build_model(cfg, device="cpu")


def test_flow_chunk_rows_rejected_where_the_jax_package_asserts():
    """FLOW_CHUNK_ROWS 12 bands a 64-row flow (64 > 12 + 16) but is no
    multiple of 8 and does not divide 64: the JAX package's PointFlow
    asserts while it traces, the port's raises ValueError."""
    images, cams, _ = make_scene_batch(1, 2, 64, 64, 8, seed=1)
    kw = dict(is_flow=True, img_scales=(1.0,), inter_scales=(0.75,), num_virtual_plane=8)
    jm = JPointMVSNet(norm="bn", flow_chunk_rows=12)
    with pytest.raises(AssertionError, match="FLOW_CHUNK_ROWS=12"):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(images),
                                       jnp.asarray(cams), **kw))
    cfg = get_default_cfg()
    cfg.MODEL.FLOW_CHUNK_ROWS = 12
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="FLOW_CHUNK_ROWS=12"), torch.inference_mode():
        model(torch.from_numpy(images), torch.from_numpy(cams), **kw)


def test_build_model_defaults():
    cfg = get_default_cfg()
    cfg.MODEL.DTYPE = "bfloat16"
    cfg.MODEL.FLOW_FETCH = "bilinear"
    cfg.MODEL.FLOW_MOMENTS = "on"
    cfg.MODEL.FLOW_CHUNK_ROWS = 0
    model = build_model(cfg, device="cpu")
    assert not model.training and model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert build_model(get_default_cfg(), device="cpu") is not None


# ------------------------------------------------------------ the whole slice

H, W, V, D = 64, 128, 3, 16
SCALES, INTER = (0.25, 0.5, 1.0), (0.75, 0.375, 0.1875)
# Kernels ×2 so the flow head's softmax is not flat and every PointFlow
# iteration moves the depth. At ×3 the JAX package itself moves flow2/3 by
# 0.14 under a 1e-6 relative input perturbation (kNN near-ties), which no
# port can track to the 0.05 bar.
KERNEL_SCALE = 2.0


@pytest.fixture(scope="module")
def slice_outputs():
    """JAX side jitted: about 30 s on the CPU with its compile, against
    about 100 s eager."""
    images, cams, _ = make_scene_batch(1, V, H, W, D, seed=4)
    jm = JPointMVSNet(norm="bn")
    flat = jax_variables(jm, np.random.RandomState(3), jnp.asarray(images[:, :, :64, :64]),
                         jnp.asarray(cams), is_flow=True, img_scales=(0.25,),
                         inter_scales=(0.75,), num_virtual_plane=8,
                         kernel_scale=KERNEL_SCALE)
    fn = jax.jit(lambda v, im, cm: jm.apply(v, im, cm, is_flow=True, img_scales=SCALES,
                                            inter_scales=INTER, num_virtual_plane=D))
    want = {k: np.asarray(v) for k, v in fn(unflatten(flat), jnp.asarray(images),
                                            jnp.asarray(cams)).items()}
    tm = PointMVSNet(norm="bn").eval()
    load_jax_variables(tm, flat)
    with torch.inference_mode():
        got = tm(torch.tensor(images), torch.tensor(cams), img_scales=SCALES,
                 inter_scales=INTER, num_virtual_plane=D)
    return want, {k: v.numpy() for k, v in got.items()}


def test_slice_depth_parity(slice_outputs):
    """The bars of tests/test_full_parity.py: max |Δdepth| < 0.05, mean
    < 0.005 on every stage; confidence max < 0.02."""
    want, got = slice_outputs
    assert sorted(got) == sorted(want)
    for key in ["coarse_depth_map", "flow1", "flow2", "flow3"]:
        diff = np.abs(got[key] - want[key])
        assert diff.max() < 0.05, f"{key}: max|Δdepth| = {diff.max():.4f}"
        assert diff.mean() < 0.005, f"{key}: mean|Δdepth| = {diff.mean():.4f}"
    assert np.abs(got["coarse_prob_map"] - want["coarse_prob_map"]).max() < 0.02


def test_slice_flows_move_depth(slice_outputs):
    """Guards the parity test against a flat softmax: each PointFlow
    iteration changes the depth it is given, in both packages."""
    want, got = slice_outputs
    for it in (1, 2, 3):
        for out in (want, got):
            assert np.abs(out[f"flow{it}"] - out[f"flow{it}_input"]).max() > 1e-3
    assert got["flow3"].shape == (1, H, W)
    assert all(np.isfinite(v).all() for v in got.values())
