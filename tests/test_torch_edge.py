"""Masked window max and EdgeConv of the PyTorch port vs the JAX package.
The port runs on CPU tensors (its plain versions); the JAX side runs
``masked_window_max_xla``, the gather formulation, and the Pallas kernel
in interpret mode."""

import flax.traverse_util as traverse_util
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointmvsnet_tpu.models.edge_conv import EdgeConv as JEdgeConv
from pointmvsnet_tpu.ops.knn import gather_knn as jgather
from pointmvsnet_tpu.ops.knn import window_knn as jwindow_knn
from pointmvsnet_tpu.ops.pallas.edge import masked_window_max as pallas_mwm
from pointmvsnet_tpu.ops.pallas.edge import masked_window_max_xla
from pointmvsnet_tpu_torch.models.edge_conv import EdgeConv
from pointmvsnet_tpu_torch.ops.edge import masked_window_max
from pointmvsnet_tpu_torch.ops.knn import gather_knn
from pointmvsnet_tpu_torch.utils.convert import jax_to_torch

G, H, W, K, WIN = 5, 16, 24, 16, 5
P = G * H * W


@pytest.fixture(scope="module")
def graph():
    rng = np.random.RandomState(0)
    pts = rng.rand(2, P, 3).astype(np.float32) * 10
    idx, mask = jwindow_knn(jnp.asarray(pts), (G, H, W), K, WIN, with_mask=True)
    return np.array(idx), np.array(mask)


@pytest.mark.parametrize("f", [8, 32])
def test_masked_window_max_exact(graph, f):
    """Equal, exactly, to masked_window_max_xla and to gather + max."""
    idx, mask = graph
    z = np.random.RandomState(f).randn(2, P, f).astype(np.float32)
    got = masked_window_max(torch.from_numpy(z), torch.from_numpy(mask.view(np.int32)),
                            (G, H, W), WIN).numpy()
    want = np.asarray(masked_window_max_xla(jnp.asarray(z), jnp.asarray(mask), (G, H, W), WIN))
    np.testing.assert_array_equal(got, want)
    truth = np.asarray(jgather(jnp.asarray(z), jnp.asarray(idx))).max(axis=2)
    np.testing.assert_array_equal(got, truth)
    port_gather = gather_knn(torch.from_numpy(z), torch.from_numpy(idx)).amax(2).numpy()
    np.testing.assert_array_equal(got, port_gather)


def test_masked_window_max_pallas_interpret_and_bf16(graph):
    idx, mask = graph
    z = np.random.RandomState(3).randn(2, P, 8).astype(np.float32)
    tmask = torch.from_numpy(mask.view(np.int32))
    want = np.asarray(pallas_mwm(jnp.asarray(z), jnp.asarray(mask), (G, H, W), WIN,
                                 interpret=True))
    got = masked_window_max(torch.from_numpy(z), tmask, (G, H, W), WIN).numpy()
    np.testing.assert_array_equal(got, want)
    # bf16 in, bf16 out: max is exact in the working type
    zb = torch.from_numpy(z).bfloat16()
    got_b = masked_window_max(zb, tmask, (G, H, W), WIN)
    assert got_b.dtype == torch.bfloat16
    want_b = masked_window_max_xla(jnp.asarray(zb.float().numpy(), jnp.bfloat16),
                                   jnp.asarray(mask), (G, H, W), WIN)
    np.testing.assert_array_equal(got_b.float().numpy(), np.asarray(want_b, np.float32))


def _jax_edgeconv(norm, x, idx, rng, f=10):
    mod = JEdgeConv(f, norm=norm)
    var = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(idx))
    var = jax.tree_util.tree_map(np.asarray, var)
    # non-trivial affine, negative scales included
    for coll, name in [("params", "scale"), ("params", "bias"),
                       ("batch_stats", "mean")]:
        for mod_name in ("BatchNorm_0", "GroupNorm_0"):
            if mod_name in var.get(coll, {}) and name in var[coll][mod_name]:
                var[coll][mod_name][name] = rng.randn(f).astype(np.float32)
    if "batch_stats" in var:
        var["batch_stats"]["BatchNorm_0"]["var"] = (rng.rand(f) + 0.5).astype(np.float32)
    return mod, var


@pytest.mark.parametrize("norm", ["bn", "none", "gn"])
def test_edgeconv_matches_jax(graph, norm):
    """Port EdgeConv (fast path for bn/none, gather path for gn) vs JAX
    EdgeConv with random BN statistics, atol 1e-5; and the port's fast
    path vs its own gather path, atol 1e-5."""
    idx, mask = graph
    rng = np.random.RandomState(2)
    x = rng.randn(2, P, 12).astype(np.float32)
    jmod, var = _jax_edgeconv(norm, x, idx, rng)
    fast = norm in ("bn", "none")
    kw = dict(mask=jnp.asarray(mask), grid_shape=(G, H, W), window=WIN) if fast else {}
    want = np.asarray(jmod.apply(var, jnp.asarray(x), jnp.asarray(idx), impl="xla", **kw)
                      if fast else jmod.apply(var, jnp.asarray(x), jnp.asarray(idx)))

    flat = {f"{coll}/point_flow/core/EdgeConv_0/{k}": v for coll in var
            for k, v in traverse_util.flatten_dict(var[coll], sep="/").items()}
    sd = {k.removeprefix("point_flow.edge_convs.0."): v
          for k, v in jax_to_torch(flat).items()}
    mod = EdgeConv(12, 10, norm).eval()
    res = mod.load_state_dict(sd, strict=False)
    assert not res.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in res.missing_keys)
    tx, tidx = torch.from_numpy(x), torch.from_numpy(idx)
    with torch.no_grad():
        gather = mod(tx, tidx).numpy()
        got = (mod(tx, tidx, mask=torch.from_numpy(mask.view(np.int32)),
                   grid_shape=(G, H, W), window=WIN).numpy() if fast else gather)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, gather, atol=1e-5, rtol=1e-5)
