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
from pointmvsnet_tpu_torch.ops.knn import gather_knn, window_knn, window_knn_mask
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
