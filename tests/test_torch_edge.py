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
from pointmvsnet_tpu_torch.ops.edge import StagingPlan
from pointmvsnet_tpu_torch.ops.edge import check_args as edge_check_args
from pointmvsnet_tpu_torch.ops.edge import masked_window_max, masked_window_max_cuda
from pointmvsnet_tpu_torch.ops.edge import staging_plan
from pointmvsnet_tpu_torch.ops.knn import gather_knn
from pointmvsnet_tpu_torch.utils.convert import jax_to_torch
from torch_threads import one_torch_thread  # noqa: F401

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


def _port_edgeconv(var, norm, c=12, f=10):
    """The port's EdgeConv in eval mode with the JAX variables ``var``."""
    flat = {f"{coll}/point_flow/core/EdgeConv_0/{k}": v for coll in var
            for k, v in traverse_util.flatten_dict(var[coll], sep="/").items()}
    sd = {k.removeprefix("point_flow.edge_convs.0."): v
          for k, v in jax_to_torch(flat).items()}
    mod = EdgeConv(c, f, norm).eval()
    res = mod.load_state_dict(sd, strict=False)
    assert not res.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in res.missing_keys)
    return mod


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

    mod = _port_edgeconv(var, norm)
    tx, tidx = torch.from_numpy(x), torch.from_numpy(idx)
    with torch.no_grad():
        gather = mod(tx, tidx).numpy()
        got = (mod(tx, tidx, mask=torch.from_numpy(mask.view(np.int32)),
                   grid_shape=(G, H, W), window=WIN).numpy() if fast else gather)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, gather, atol=1e-5, rtol=1e-5)


def _assert_same_bits(got: np.ndarray, want: np.ndarray) -> None:
    """Bitwise equality up to NaN payloads: NaN at the same places, then the
    same sign bits and values elsewhere (assert_array_equal alone takes
    −0 == +0 and NaN == NaN)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(np.signbit(got[~nan]), np.signbit(want[~nan]))
    np.testing.assert_array_equal(got[~nan], want[~nan])


def _special_z(kind: str, f: int = 8) -> np.ndarray:
    rng = np.random.RandomState({"nan": 11, "zeros": 12}[kind])
    if kind == "nan":
        z = rng.randn(2, P, f).astype(np.float32)
        z[0, rng.choice(P, 3, replace=False)] = np.nan      # whole NaN rows
        z[1, rng.choice(P, 40), rng.randint(0, f, 40)] = np.nan
        return z
    # exact ties and signed zeros only; mostly −0 and −1, so that many
    # outputs are −0 and many others +0
    return rng.choice(np.array([-0.0, 0.0, 1.0, -1.0], np.float32), (2, P, f),
                      p=[0.6, 0.05, 0.05, 0.3])


def _random_mask(in_image: bool) -> np.ndarray:
    """Random selection bitplanes that no kNN makes: about 30 of the 125
    bits per point, bits ≥ 125 of the last word set too, 10% of the
    points empty; with ``in_image`` the bits pointing outside the image
    are cleared (the Pallas kernel's rolls wrap there, so it is held to
    in-image bits only)."""
    rng = np.random.RandomState(7 + in_image)
    nw = -(-(G * WIN * WIN) // 32)
    bits = rng.rand(2, nw * 32, G, H, W) < 0.25
    bits &= (rng.rand(2, 1, G, H, W) >= 0.1)
    if in_image:
        s = np.arange(nw * 32)
        dy, dx = (s % 25) // WIN - WIN // 2, s % WIN - WIN // 2
        ys, xs = np.arange(H)[:, None], np.arange(W)[None, :]
        inside = ((ys + dy[:, None, None] >= 0) & (ys + dy[:, None, None] < H)
                  & (xs + dx[:, None, None] >= 0) & (xs + dx[:, None, None] < W))
        bits &= (inside & (s < G * 25)[:, None, None])[None, :, None]
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))[:, None, None, None]
    return np.stack([(bits[:, w * 32:(w + 1) * 32].astype(np.uint64) * weights).sum(1)
                     for w in range(nw)], 1).astype(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masks", ["knn", "random", "random_in_image"])
@pytest.mark.parametrize("kind", ["nan", "zeros"])
def test_masked_window_max_nan_and_signed_zero(graph, kind, masks, dtype):
    """NaN wins and +0 wins over −0, as jnp.maximum: the port's masked max
    equals masked_window_max_xla bit for bit (NaN positions, sign bits,
    values) on NaN rows and on {−0, +0, ±1} inputs, under kNN masks and
    random ones (out-of-image bits, empty masks); and the Pallas kernel in
    interpret mode where its masks hold in-image bits only."""
    mask = graph[1] if masks == "knn" else _random_mask(masks == "random_in_image")
    z = _special_z(kind)
    jz = jnp.asarray(z, dtype)
    zt = torch.from_numpy(z)
    if dtype == "bfloat16":
        zt = zt.bfloat16()
    got = masked_window_max(zt, torch.from_numpy(mask.view(np.int32)), (G, H, W), WIN)
    assert got.dtype == zt.dtype
    got = got.float().numpy()
    want = masked_window_max_xla(jz, jnp.asarray(mask), (G, H, W), WIN)
    _assert_same_bits(got, want)
    if kind == "zeros":   # the inputs exercise both zeros and exact ties
        assert np.signbit(want[want == 0]).any() and (~np.signbit(want[want == 0])).any()
    else:
        assert np.isnan(want).any() and not np.isnan(want).all()
    if masks != "random":
        _assert_same_bits(got, pallas_mwm(jz, jnp.asarray(mask), (G, H, W), WIN,
                                          interpret=True))


@pytest.mark.parametrize("norm", ["bn", "none"])
def test_edgeconv_fast_path_propagates_nan(graph, norm):
    """One NaN feature row: EdgeConv's fast path gives NaN at the same
    outputs as JAX EdgeConv and as the port's own gather path (amax), and
    agrees with both elsewhere to 1e-5."""
    idx, mask = graph
    rng = np.random.RandomState(9)
    x = rng.randn(2, P, 12).astype(np.float32)
    x[0, 37] = np.nan
    jmod, var = _jax_edgeconv(norm, x, idx, rng)
    want = np.asarray(jmod.apply(var, jnp.asarray(x), jnp.asarray(idx), impl="xla",
                                 mask=jnp.asarray(mask), grid_shape=(G, H, W), window=WIN))
    mod = _port_edgeconv(var, norm)
    tx, tidx = torch.from_numpy(x), torch.from_numpy(idx)
    with torch.no_grad():
        gather = mod(tx, tidx).numpy()
        got = mod(tx, tidx, mask=torch.from_numpy(mask.view(np.int32)),
                  grid_shape=(G, H, W), window=WIN).numpy()
    nan = np.isnan(want)
    assert nan.any() and not nan.all()
    for other in (got, gather):
        np.testing.assert_array_equal(np.isnan(other), nan)
        np.testing.assert_allclose(other[~nan], want[~nan], atol=1e-5, rtol=1e-5)


# ------------------------------------------------ the kernels' whole envelope

# (G, window, k): masked max shapes off the tuned kernel (window 5, G ≤ 5),
# with their masks from the kNN at k
ENVELOPE = [(7, 3, 8), (2, 7, 12)]
EH, EW = 8, 16


@pytest.fixture(scope="module", params=ENVELOPE, ids=lambda s: "G{}-win{}".format(*s[:2]))
def envelope_graph(request):
    g, win, k = request.param
    pts = np.random.RandomState(g * 10 + win).rand(2, g * EH * EW, 3).astype(np.float32) * 10
    _, mask = jwindow_knn(jnp.asarray(pts), (g, EH, EW), k, win, with_mask=True)
    return g, win, np.array(mask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", [10, 160])
def test_envelope_plain_matches_pallas_and_xla(envelope_graph, f, dtype):
    """The plain masked max, the general kernel's oracle, equal bit for bit
    to masked_window_max_xla at windows 3 and 7, G 7 and 2, F 10 and 160,
    f32 and bf16, and to the Pallas kernel in interpret mode at window 3.
    The Pallas kernel repacks each level's window bits into one 32-bit word
    (``_repack_mask``), so at window 7 (49 bits) its trace overflows
    uint32: there the XLA twin is the JAX package's result."""
    g, win, mask = envelope_graph
    grid = (g, EH, EW)
    z = np.random.RandomState(f + g).randn(2, g * EH * EW, f).astype(np.float32)
    jz = jnp.asarray(z, dtype)
    zt = torch.from_numpy(z)
    if dtype == "bfloat16":
        zt = zt.bfloat16()
    got = masked_window_max(zt, torch.from_numpy(mask.view(np.int32)), grid, win)
    assert got.dtype == zt.dtype
    got = got.float().numpy()
    _assert_same_bits(got, masked_window_max_xla(jz, jnp.asarray(mask), grid, win))
    if win * win <= 32:
        _assert_same_bits(got, pallas_mwm(jz, jnp.asarray(mask), grid, win, interpret=True))
    else:
        with pytest.raises(OverflowError):
            pallas_mwm(jz, jnp.asarray(mask), grid, win, interpret=True)


@pytest.mark.parametrize("g,win,dtype,match", [
    (5, 4, torch.float32, "window must be odd"), (6, 5, torch.float32, "128 candidate"),
    (15, 3, torch.bfloat16, "128 candidate"), (5, 5, torch.float16, "float32 or bfloat16")])
def test_edge_kernel_variant_raises(g, win, dtype, match):
    """The kernel's launch plan and argument checks reject an even window,
    more than 128 candidates and a dtype other than f32 or bf16, with the
    kNN's messages."""
    with pytest.raises(ValueError, match=match):
        staging_plan(g, win, 8, dtype)
    nw = -(-(g * win * win) // 32)
    with pytest.raises(ValueError, match=match):
        edge_check_args(torch.zeros(1, g * 6, 8, dtype=dtype),
                        torch.zeros(1, nw, g, 2, 3, dtype=torch.int32), (g, 2, 3), win)


def test_edge_check_args_accept_the_envelope():
    """The CUDA wrapper's argument checks (no launch) accept every window,
    G and F inside the envelope in f32 and bf16, any B (past the 65535
    blocks of a grid's third dimension too), returning the kernel's staging
    plan, and reject a mask of the wrong shape or type and a non-contiguous
    z."""
    for win in range(1, 12, 2):
        for g in range(1, 128 // (win * win) + 1):
            nw = -(-(g * win * win) // 32)
            mask = torch.zeros(2, nw, g, 2, 3, dtype=torch.int32)
            for f in (1, 10, 160):
                for dt in (torch.float32, torch.bfloat16):
                    z = torch.zeros(2, g * 6, f, dtype=dt)
                    plan = edge_check_args(z, mask, (g, 2, 3), win)
                    assert isinstance(plan, StagingPlan) and plan == staging_plan(g, win, f, dt)
    b = 65536
    assert edge_check_args(torch.zeros(b, 5, 32, dtype=torch.bfloat16),
                           torch.zeros(b, 4, 5, 1, 1, dtype=torch.int32),
                           (5, 1, 1), 5) == staging_plan(5, 5, 32, torch.bfloat16)
    z = torch.zeros(1, 7 * 6, 20)
    mask = torch.zeros(1, 2, 7, 2, 3, dtype=torch.int32)
    for bad_z, bad_mask in ((z[:, :, ::2], mask), (z, mask.long()), (z, mask[:, :1])):
        with pytest.raises(ValueError):
            edge_check_args(bad_z, bad_mask, (7, 2, 3), 3)
    with pytest.raises(ValueError, match="CUDA"):
        masked_window_max_cuda(z, mask, (7, 2, 3), 3)


@pytest.mark.parametrize("f", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staging_plan_at_the_cells_shapes(f, dtype):
    """At the model's EdgeConv shapes (G 5, window 5, F 32 and 64) the
    kernel stages 4×32 tiles in 64-byte chunks, two blocks to an SM."""
    plan = staging_plan(5, 5, f, dtype)
    assert plan == StagingPlan(tile_rows=4, chunk_bytes=64)
    staged = 5 * (4 + 4) * (32 + 4) * 64 + 1 * 5 * 4 * 32 * 4 + 512
    assert 2 * (staged + 1024) <= 233_472


@pytest.mark.parametrize("win", [1, 3, 5, 7, 9, 11])
def test_staging_plan_fits_the_envelope(win):
    """The masked max has a staging plan for every G with
    G·win² ≤ 128, F 10/32/64/160, f32 and bf16: its rows with halo, mask
    words and bit table fit a block's 232,448 bytes, TH ≥ 1, its chunks
    cover F and none is wider than F needs, no wider chunk fits with any
    TH, and it takes two blocks per SM wherever some TH with its chunk
    does."""
    r = win // 2
    for g in range(1, 128 // (win * win) + 1):
        nw = -(-(g * win * win) // 32)

        def smem(th, chunk):
            return g * (th + 2 * r) * (32 + 2 * r) * chunk + nw * g * th * 32 * 4 + 512

        for f in (10, 32, 64, 160):
            for dt in (torch.float32, torch.bfloat16):
                th, chunk = staging_plan(g, win, f, dt)
                assert th in (1, 2, 4, 8) and chunk in (16, 32, 64)
                assert smem(th, chunk) <= 232_448
                row = f * (4 if dt == torch.float32 else 2)
                chunks = -(-row // chunk)
                assert (chunks - 1) * chunk < row <= chunks * chunk
                assert chunk == 16 or chunk // 2 < row
                for wider in (c for c in (32, 64) if c > chunk and c // 2 < row):
                    assert all(smem(t, wider) > 232_448 for t in (1, 2, 4, 8))
                if any(2 * (smem(t, chunk) + 1024) <= 233_472 for t in (1, 2, 4, 8)):
                    assert 2 * (smem(th, chunk) + 1024) <= 233_472
    if win == 1:
        assert staging_plan(128, 1, 64, torch.bfloat16).tile_rows == 1
    if win == 3:
        wide = staging_plan(1, 3, 2 ** 21 + 8, torch.bfloat16)       # chip_smoke's ENV_WIDE
        assert -(-(2 ** 22 + 16) // wide.chunk_bytes) > 65535
