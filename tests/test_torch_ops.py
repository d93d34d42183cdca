"""PyTorch port vs the JAX package: geometry, sampling, cost volume and
preprocessing on the same numpy inputs, plus the port's import and device
rules. The port runs with CPU tensors, i.e. its plain versions."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointmvsnet_tpu.dataset import preprocess as jpre
from pointmvsnet_tpu.ops import cost_volume as jcv
from pointmvsnet_tpu.ops import geometry as jgeo
from pointmvsnet_tpu.ops import sampling as jsamp
from pointmvsnet_tpu_torch import resolve_device
from pointmvsnet_tpu_torch.dataset import preprocess as tpre
from pointmvsnet_tpu_torch.ops import cost_volume as tcv
from pointmvsnet_tpu_torch.ops import geometry as tgeo
from pointmvsnet_tpu_torch.ops import sampling as tsamp
from pointmvsnet_tpu_torch.ops.edge import masked_window_max_cuda
from pointmvsnet_tpu_torch.ops.knn import window_knn_cuda
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
H, W = 12, 16          # feature-map size of the sampling tests


def make_cams(rng, v=3, h=H, w=W):
    """Pinhole cams with skew and small rotations, DTU-like depth range."""
    cams = np.zeros((1, v, 2, 4, 4), np.float32)
    for vi in range(v):
        a = 0.03 * rng.randn(3)
        rx = np.array([[1, 0, 0], [0, np.cos(a[0]), -np.sin(a[0])],
                       [0, np.sin(a[0]), np.cos(a[0])]])
        ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])], [0, 1, 0],
                       [-np.sin(a[1]), 0, np.cos(a[1])]])
        e = np.eye(4)
        e[:3, :3] = rx @ ry
        e[:3, 3] = [-5.0 * vi, 0.3 * rng.randn(), 0.3 * rng.randn()]
        f = 1.2 * max(h, w)
        cams[0, vi, 0] = e
        cams[0, vi, 1, :3, :3] = [[f, 0.01, w / 2], [0, f * 1.01, h / 2], [0, 0, 1]]
        cams[0, vi, 1, 3] = [425.0, 2.5, 8, 442.5]
    return cams


def world_points(rng, cams, n=400):
    """Points in front of view 0 inside its frustum (depth 420-470)."""
    pix = np.stack([rng.rand(n) * (W - 1), rng.rand(n) * (H - 1), np.ones(n)], -1)
    depth = 420 + 50 * rng.rand(n)
    pts = jgeo.unproject_pixels(jnp.asarray(pix, jnp.float32)[None],
                                jnp.asarray(depth, jnp.float32)[None],
                                jnp.asarray(cams[:, 0, 0]), jnp.asarray(cams[:, 0, 1, :3, :3]))
    return np.asarray(pts, np.float32)                       # (1, n, 3)


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- geometry

def test_unproject_project_match(rng):
    """World points and projections agree to atol 1e-4 (f32, values ~500)."""
    cams = make_cams(rng)
    pix = np.asarray(jgeo.pixel_grid(H, W))
    depth = (400 + 100 * rng.rand(1, H * W)).astype(np.float32)
    np.testing.assert_array_equal(tgeo.pixel_grid(H, W).numpy(), pix)
    args = (cams[:, 0, 0], cams[:, 0, 1, :3, :3])
    jw = np.asarray(jgeo.unproject_pixels(jnp.asarray(pix)[None], jnp.asarray(depth),
                                          *map(jnp.asarray, args)))
    tw = tgeo.unproject_pixels(t(pix)[None], t(depth), *map(t, args)).numpy()
    np.testing.assert_allclose(tw, jw, atol=1e-4, rtol=0)
    k = cams[0, :, 1, :3, :3]
    np.testing.assert_allclose(tgeo.intrinsic_inverse(t(k)).numpy(),
                               np.asarray(jgeo.intrinsic_inverse(jnp.asarray(k))),
                               atol=1e-7, rtol=0)
    juv, jz = jgeo.project_points(jnp.asarray(jw)[:, None], jnp.asarray(cams[:, :, 0]),
                                  jnp.asarray(cams[:, :, 1, :3, :3]))
    tuv, tz = tgeo.project_points(t(jw)[:, None], t(cams[:, :, 0]), t(cams[:, :, 1, :3, :3]))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-4, rtol=0)
    d_min, d_int = t(cams[:, 0, 1, 3, 0]), t(cams[:, 0, 1, 3, 1])
    np.testing.assert_array_equal(
        tgeo.depth_hypotheses(d_min, d_int, 8).numpy(),
        np.asarray(jgeo.depth_hypotheses(jnp.asarray(d_min.numpy()),
                                         jnp.asarray(d_int.numpy()), 8)))


# ---------------------------------------------------------------- sampling
# atol 2e-5: the bar of tests/test_full_parity.py for the fetch

def test_bilinear_sample_borders_and_valid(rng):
    feat = rng.rand(2, H, W, 8).astype(np.float32)
    uv = np.stack([rng.uniform(-2, W + 1, (2, 300)), rng.uniform(-2, H + 1, (2, 300))],
                  -1).astype(np.float32)
    uv[:, :4] = [[0, 0], [W - 1, H - 1], [W - 1, 0], [-0.5, H - 0.5]]  # corners, edges
    valid = rng.rand(2, 300) > 0.2
    want = np.asarray(jsamp.bilinear_sample(jnp.asarray(feat), jnp.asarray(uv),
                                            jnp.asarray(valid)))
    got = tsamp.bilinear_sample(t(feat), t(uv), t(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("sx,sy,oh,ow", [(0.5, 0.5, 2 * H, 2 * W), (1.0, 1.0, H, W),
                                         (0.25, 0.25, 4 * H, 4 * W)])
def test_regular_grid_sample(rng, sx, sy, oh, ow):
    feat = rng.randn(2, H, W, 6).astype(np.float32)
    want = np.asarray(jsamp.regular_grid_sample(jnp.asarray(feat), sx, sy, oh, ow))
    got = tsamp.regular_grid_sample(t(feat), sx, sy, oh, ow).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("shape,out", [((16, 20), (32, 40)), ((7, 9), (28, 36)),
                                       ((13, 17), (26, 31))])
def test_resize_bilinear(rng, shape, out):
    """The flow iterations' depth upsampling: within 1e-4 (f32 on values
    near 500) of F.interpolate and of the JAX package's jax.image.resize."""
    import jax
    import torch.nn.functional as F
    x = (500 + 20 * rng.randn(2, *shape)).astype(np.float32)
    got = tsamp.resize_bilinear(t(x), *out)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *out), method="bilinear"))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    ref = F.interpolate(t(x)[:, None], out, mode="bilinear", align_corners=False)[:, 0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4, rtol=0)


def test_fetch_features_and_moments(rng):
    cams = make_cams(rng)
    pts = world_points(rng, cams)
    feats = rng.rand(1, 3, H, W, 8).astype(np.float32)
    want = np.asarray(jsamp.fetch_features(jnp.asarray(feats), jnp.asarray(pts),
                                           jnp.asarray(cams)))
    got = tsamp.fetch_features(t(feats), t(pts), t(cams)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)

    levels = [rng.rand(1, 3, H >> l, W >> l, 4 << l).astype(np.float32) for l in range(3)]
    js1, js2 = jsamp.fetch_features_perlevel([jnp.asarray(f) for f in levels],
                                             jnp.asarray(pts), jnp.asarray(cams),
                                             reduce="moments")
    ts1, ts2 = tsamp.fetch_features_perlevel([t(f) for f in levels], t(pts), t(cams))
    np.testing.assert_allclose(ts1.numpy(), np.asarray(js1), atol=2e-5, rtol=0)
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js2), atol=2e-5, rtol=0)


# ---------------------------------------------------------------- cost volume
# atol 1e-5

def test_plane_sweep_volume(rng):
    cams = make_cams(rng)
    feats = rng.rand(1, 3, H, W, 8).astype(np.float32)
    depths = (425.0 + 2.5 * np.arange(8, dtype=np.float32))[None]
    depths[0, 0] = -1.0                       # the ref-view shortcut's z ≤ 0 mask
    want = np.asarray(jcv.plane_sweep_volume(jnp.asarray(feats), jnp.asarray(cams),
                                             jnp.asarray(depths), impl="take"))
    got = tcv.plane_sweep_volume(t(feats), t(cams), t(depths)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_depth_regression_and_confidence(rng):
    logits = rng.randn(2, 16, 5, 7).astype(np.float32) * 3
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    depths = (425.0 + 2.5 * np.arange(16, dtype=np.float32))[None].repeat(2, 0)
    np.testing.assert_allclose(
        tcv.depth_regression(t(prob), t(depths)).numpy(),
        np.asarray(jcv.depth_regression(jnp.asarray(prob), jnp.asarray(depths))),
        atol=1e-5 * 440, rtol=0)                 # 1e-5 relative to the depth
    np.testing.assert_allclose(
        tcv.photometric_confidence(t(prob)).numpy(),
        np.asarray(jcv.photometric_confidence(jnp.asarray(prob))), atol=1e-5, rtol=0)


# ---------------------------------------------------------------- preprocessing

def test_preprocess_matches(rng):
    imgs = [(rng.rand(70, 130, 3) * 255).astype(np.float32) for _ in range(2)]
    cams = [make_cams(rng)[0, 0] for _ in range(2)]
    np.testing.assert_allclose(tpre.norm_image(imgs[0]), jpre.norm_image(imgs[0]),
                               rtol=1e-6)
    np.testing.assert_array_equal(tpre.scale_camera(cams[0], (0.5, 0.25)),
                                  jpre.scale_camera(cams[0], (0.5, 0.25)))
    ti, tc = tpre.crop_mvs_input(imgs, cams, 70, 130, base=64)
    ji, jc = jpre.crop_mvs_input(imgs, cams, 70, 130, base=64)
    for a, b in zip(ti + tc, ji + jc):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- port rules

def _port_sources():
    files = sorted((REPO / "pointmvsnet_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax():
    """No import whose top-level name is jax, flax, optax, orbax or exactly
    pointmvsnet_tpu (a prefix test would also hit pointmvsnet_tpu_torch)."""
    banned = {"jax", "flax", "optax", "orbax", "pointmvsnet_tpu"}
    bad = []
    files = _port_sources()
    assert len(files) > 10 and files[-1].exists()
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names if n.split(".")[0] in banned]
    assert not bad, bad


def test_no_cuda_means_raise(monkeypatch):
    """Entry points default to CUDA and raise without it; the kernel
    wrappers never run on CPU tensors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    pts = torch.zeros(1, 5 * 8 * 8, 3)
    with pytest.raises(ValueError):
        window_knn_cuda(pts, (5, 8, 8))
    z = torch.zeros(1, 5 * 8 * 8, 8)
    mask = torch.zeros(1, 4, 5, 8, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        masked_window_max_cuda(z, mask, (5, 8, 8))
