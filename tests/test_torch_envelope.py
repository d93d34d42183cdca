"""The whole eval slice of the PyTorch port against the JAX package at
kNN shapes off the tuned CUDA kernels (k = 16, window 5, G = 5): MODEL.KNN
8 at windows 5 and 3, and FLOW_INTERVAL_M 3 (G = 7) at window 3, the
shapes the JAX package's Pallas kernels and its own tests run. A tiny
BatchNorm model (base 4, EdgeConv (8, 8)) at 64×128, V=3, D=16, flows at
0.25 and 0.5, the JAX variables converted; the port on the CPU, i.e.
through the plain versions of its kernels, which the general CUDA kernels
match bit for bit on the card (chip_smoke.py, phase envelope)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointmvsnet_tpu.models.pointmvsnet import PointMVSNet as JPointMVSNet
from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
from pointmvsnet_tpu_torch.models.pointmvsnet import PointMVSNet
from pointmvsnet_tpu_torch.ops import edge, knn
from pointmvsnet_tpu_torch.utils.convert import load_jax_variables
from test_torch_model import jax_variables, unflatten
from torch_threads import one_torch_thread  # noqa: F401

H, W, V, D = 64, 128, 3, 16
SCALES, INTER = (0.25, 0.5), (0.75, 0.375)
KERNEL_SCALE = 2.0          # tests/test_torch_model.py says why
WIDTHS = dict(img_base_channels=4, vol_base_channels=4, edge_channels=(8, 8),
              flow_channels=(8, 1), norm="bn")
# (MODEL.KNN, MODEL.KNN_WINDOW, MODEL.FLOW_INTERVAL_M)
CASES = [(8, 5, 2), (8, 3, 2), (16, 3, 3)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "knn{}-win{}-m{}".format(*c))
def slice_outputs(request):
    k, win, m = request.param
    shape = dict(knn=k, knn_window=win, flow_m=m)
    images, cams, _ = make_scene_batch(1, V, H, W, D, seed=4)
    jm = JPointMVSNet(**WIDTHS, **shape)
    flat = jax_variables(jm, np.random.RandomState(3), jnp.asarray(images[:, :, :64, :64]),
                         jnp.asarray(cams), is_flow=True, img_scales=(0.25,),
                         inter_scales=(0.75,), num_virtual_plane=8,
                         kernel_scale=KERNEL_SCALE)
    fn = jax.jit(lambda v, im, cm: jm.apply(v, im, cm, is_flow=True, img_scales=SCALES,
                                            inter_scales=INTER, num_virtual_plane=D))
    want = {key: np.asarray(v) for key, v in fn(unflatten(flat), jnp.asarray(images),
                                                jnp.asarray(cams)).items()}
    tm = PointMVSNet(**WIDTHS, **shape).eval()
    load_jax_variables(tm, flat)
    with torch.inference_mode():
        got = tm(torch.tensor(images), torch.tensor(cams), img_scales=SCALES,
                 inter_scales=INTER, num_virtual_plane=D)
    return request.param, want, {key: v.numpy() for key, v in got.items()}


def test_envelope_depth_parity(slice_outputs):
    """The bars of tests/test_full_parity.py: max |Δdepth| < 0.05, mean
    < 0.005 on every stage; confidence max < 0.02."""
    _, want, got = slice_outputs
    assert sorted(got) == sorted(want)
    for key in ["coarse_depth_map", "flow1", "flow2"]:
        diff = np.abs(got[key] - want[key])
        assert diff.max() < 0.05, f"{key}: max|Δdepth| = {diff.max():.4f}"
        assert diff.mean() < 0.005, f"{key}: mean|Δdepth| = {diff.mean():.4f}"
    assert np.abs(got["coarse_prob_map"] - want["coarse_prob_map"]).max() < 0.02


def test_envelope_flows_move_depth(slice_outputs):
    """Guards the parity test against a flat softmax: each PointFlow
    iteration changes the depth it is given, in both packages."""
    _, want, got = slice_outputs
    for it in (1, 2):
        for out in (want, got):
            assert np.abs(out[f"flow{it}"] - out[f"flow{it}_input"]).max() > 1e-3
    assert all(np.isfinite(v).all() for v in got.values())


def test_envelope_takes_the_general_kernels(slice_outputs):
    """On the card these shapes run the general kNN, and the masked max
    with a staging plan whose tile and chunks fit a block; nothing
    raises."""
    (k, win, m), _, _ = slice_outputs
    g = 2 * m + 1
    assert knn.kernel_variant(g, k, win) == "general"
    for f in WIDTHS["edge_channels"]:
        for dt in (torch.float32, torch.bfloat16):
            plan = edge.staging_plan(g, win, f, dt)
            assert plan.tile_rows in (1, 2, 4, 8) and plan.chunk_bytes in (16, 32, 64)
