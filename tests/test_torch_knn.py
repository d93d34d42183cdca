"""Windowed kNN of the PyTorch port vs the JAX package: indices and
selection masks bit-equal to ``ops/knn.py::window_knn(with_mask=True)`` and
to the Pallas kernel in interpret mode, including exact-tie inputs and the
corner pixels. The port runs on CPU tensors (its plain version)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointmvsnet_tpu.ops.knn import gather_knn as jgather
from pointmvsnet_tpu.ops.knn import window_knn as jwindow_knn
from pointmvsnet_tpu.ops.pallas.knn import pallas_window_knn_mask
from pointmvsnet_tpu_torch.ops.knn import (check_args, gather_knn, kernel_variant, tile_rows,
                                           window_knn, window_knn_cuda, window_knn_mask)
from torch_threads import one_torch_thread  # noqa: F401

B, G, H, W, K, WIN = 2, 5, 16, 24, 16, 5
P = G * H * W


def make_points(case: str) -> np.ndarray:
    rng = np.random.RandomState({"random": 0, "ties": 1, "duplicates": 2}[case])
    pts = rng.rand(B, P, 3).astype(np.float32) * 10
    if case == "ties":
        # integer lattice coordinates: many candidates at exactly equal d²,
        # so the order rests on the candidate id in the packed key
        pts = rng.randint(0, 3, (B, P, 3)).astype(np.float32)
    elif case == "duplicates":
        # every hypothesis level of each pixel at the same point
        grid = pts.reshape(B, G, H, W, 3)
        pts = np.broadcast_to(grid[:, :1], grid.shape).reshape(B, P, 3).copy()
    return pts


@pytest.fixture(scope="module", params=["random", "ties", "duplicates"])
def knn_pair(request):
    pts = make_points(request.param)
    jidx, jmask = jwindow_knn(jnp.asarray(pts), (G, H, W), K, WIN, with_mask=True)
    tidx, tmask = window_knn(torch.from_numpy(pts), (G, H, W), K, WIN, with_mask=True)
    return pts, (np.asarray(jidx), np.asarray(jmask)), (tidx.numpy(), tmask.numpy())


def test_idx_and_mask_bit_equal(knn_pair):
    _, (jidx, jmask), (tidx, tmask) = knn_pair
    assert tidx.dtype == np.int32 and tmask.dtype == np.int32
    np.testing.assert_array_equal(tidx, jidx)
    # the port stores the uint32 bitplanes as int32 with the same bits
    np.testing.assert_array_equal(tmask.view(np.uint32), jmask)


def test_corners_and_popcount(knn_pair):
    _, _, (tidx, tmask) = knn_pair
    words = tmask.view(np.uint32).astype(np.uint64)
    pop = sum(((words >> np.uint64(s)) & np.uint64(1)) for s in range(32)).sum(axis=1)
    np.testing.assert_array_equal(pop, K)
    grid = tidx.reshape(B, G, H, W, K)
    ys, xs = (grid % (H * W)) // W, grid % W
    for y, x in [(0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1)]:
        assert (np.abs(ys[:, :, y, x] - y) <= WIN // 2).all()
        assert (np.abs(xs[:, :, y, x] - x) <= WIN // 2).all()
    assert tidx.min() >= 0 and tidx.max() < P


def test_matches_pallas_kernel_interpret():
    pts = make_points("random")
    pidx, pmask = pallas_window_knn_mask(jnp.asarray(pts), (G, H, W), K, WIN,
                                         interpret=True)
    tidx, tmask = window_knn(torch.from_numpy(pts), (G, H, W), K, WIN, with_mask=True)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(pidx))
    np.testing.assert_array_equal(tmask.numpy().view(np.uint32), np.asarray(pmask))


def test_dispatch_and_gather(knn_pair):
    pts, _, (tidx, tmask) = knn_pair
    idx, mask = window_knn_mask(torch.from_numpy(pts), (G, H, W), K, WIN)
    np.testing.assert_array_equal(idx.numpy(), tidx)
    np.testing.assert_array_equal(mask.numpy(), tmask)
    assert window_knn(torch.from_numpy(pts), (G, H, W), K, WIN).numpy().tolist() == tidx.tolist()
    feats = np.random.RandomState(5).randn(B, P, 7).astype(np.float32)
    np.testing.assert_array_equal(
        gather_knn(torch.from_numpy(feats), torch.from_numpy(tidx)).numpy(),
        np.asarray(jgather(jnp.asarray(feats), jnp.asarray(tidx))))


# ------------------------------------------------ the kernels' whole envelope

# (G, H, W, k, window): shapes the Pallas kernel runs that the tuned CUDA
# kernel (k = 16, window 5) does not; the general kernel takes them
ENVELOPE = [(3, 8, 8, 6, 3), (5, 8, 16, 12, 5), (7, 8, 16, 8, 3), (1, 8, 16, 36, 11)]


@pytest.fixture(scope="module", params=ENVELOPE, ids=lambda s: "G{}-{}x{}-k{}-win{}".format(*s))
def envelope_pair(request):
    g, h, w, k, win = request.param
    pts = np.random.RandomState(g * 100 + k).rand(2, g * h * w, 3).astype(np.float32) * 10
    tidx, tmask = window_knn(torch.from_numpy(pts), (g, h, w), k, win, with_mask=True)
    return request.param, pts, tidx.numpy(), tmask.numpy()


def test_envelope_plain_matches_jax(envelope_pair):
    """The plain version, the general kernel's oracle, bit-equal in idx and
    mask to the JAX package's window_knn at shapes off the tuned kernel."""
    (g, h, w, k, win), pts, tidx, tmask = envelope_pair
    jidx, jmask = jwindow_knn(jnp.asarray(pts), (g, h, w), k, win, with_mask=True)
    assert tidx.shape == (2, g * h * w, k) and tmask.shape[1] == -(-(g * win * win) // 32)
    np.testing.assert_array_equal(tidx, np.asarray(jidx))
    np.testing.assert_array_equal(tmask.view(np.uint32), np.asarray(jmask))


def test_envelope_plain_matches_pallas_interpret(envelope_pair):
    (g, h, w, k, win), pts, tidx, tmask = envelope_pair
    pidx, pmask = pallas_window_knn_mask(jnp.asarray(pts), (g, h, w), k, win,
                                         interpret=True)
    np.testing.assert_array_equal(tidx, np.asarray(pidx))
    np.testing.assert_array_equal(tmask.view(np.uint32), np.asarray(pmask))


def envelope_shapes():
    """Every (G, k, window) the plain version takes."""
    for win in range(1, 12, 2):
        for g in range(1, 128 // (win * win) + 1):
            for k in range(0, g * (win // 2 + 1) ** 2 + 1):
                yield g, k, win


def test_kernel_variant_tuned_only_at_the_paper_shape():
    assert kernel_variant(5, 16, 5) == "tuned"
    shapes = list(envelope_shapes())
    assert len(shapes) > 1000 and max(k for _, k, _ in shapes) == 128
    tuned = [s for s in shapes if kernel_variant(*s) == "tuned"]
    assert tuned == [(g, 16, 5) for g in (2, 3, 4, 5)]
    assert all(kernel_variant(*s) == "general" for s in shapes if s not in tuned)


@pytest.mark.parametrize("g,k,win", [(5, 16, 4), (6, 16, 5), (129, 1, 1), (15, 8, 3),
                                     (1, 10, 5), (3, 13, 3)])
def test_kernel_variant_raises_as_the_plain_version(g, k, win):
    """Outside the envelope the rule raises what the plain version raises."""
    pts = torch.zeros(1, g * 3 * 3, 3)
    with pytest.raises(ValueError) as plain:
        window_knn(pts, (g, 3, 3), k, win)
    with pytest.raises(ValueError) as rule:
        kernel_variant(g, k, win)
    assert str(rule.value) == str(plain.value)
    with pytest.raises(ValueError, match=str(plain.value)):
        check_args(pts, (g, 3, 3), k, win)


def test_check_args_accept_the_envelope():
    """The CUDA wrapper's argument checks (no launch) accept every shape
    inside the envelope, and reject a wrong dtype, layout or size."""
    for g, k, win in envelope_shapes():
        pts = torch.empty(2, g * 4 * 6, 3)
        assert check_args(pts, (g, 4, 6), k, win) == kernel_variant(g, k, win)
    pts = torch.empty(1, 5 * 4 * 6, 3)
    for bad in (pts.double(), pts[:, ::2], torch.empty(1, 5 * 4 * 6, 4)):
        with pytest.raises(ValueError):
            check_args(bad, (5, 4, 6), 16, 5)
    with pytest.raises(ValueError, match="int32"):
        check_args(torch.empty(1, 5 * 2 ** 12 * 2 ** 12, 3, device="meta"),
                   (5, 2 ** 12, 2 ** 12), 26, 5)
    with pytest.raises(ValueError, match="CUDA"):
        window_knn_cuda(pts, (5, 4, 6), 8, 5)


@pytest.mark.parametrize("win", [1, 3, 5, 7, 9, 11])
def test_tile_rows_fit_the_envelope(win):
    """The general kNN's tile for every G with G·win² ≤ 128: TH in (1, 2,
    4, 8), its coordinates with halo fit a block's 232,448 bytes, one
    point per thread up to G = 16, and in the kernel's query loop (thread
    t takes points t, t + threads, ... of G·TH·32, threads = min(G·TH·32,
    512)) the 32 lanes of each warp loop the same number of times, as the
    warp vote needs."""
    r = win // 2
    for g in range(1, 128 // (win * win) + 1):
        th = tile_rows(g, win)
        assert th in (1, 2, 4, 8)
        assert g * (th + 2 * r) * (32 + 2 * r) * 16 <= 232_448
        points = g * th * 32
        threads = min(points, 512)
        loops = [len(range(t, points, threads)) for t in range(threads)]
        assert all(len(set(loops[w:w + 32])) == 1 for w in range(0, threads, 32))
        if g <= 16:
            assert threads == points
