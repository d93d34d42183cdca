"""CasMVSNet in the PyTorch port (``models/casmvsnet.py``) against the plain
reference (``tests/casmvsnet_reference.py``), the per-pixel plane sweep
against the planes path, Point-MVSNet's coarse path against the code it
had before the sweep took per-pixel depths, the confidence at the
regressed index, and both models through ``Predictor`` and the test CLI.
The port runs on the CPU, f32, at V = 3, 64×96, ``ndepths`` (8, 8, 8)."""

import glob
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pointmvsnet_tpu_torch.config import get_default_cfg, load_cfg_from_file
from pointmvsnet_tpu_torch.models import build_metric_fn, build_model
from pointmvsnet_tpu_torch.models.image_conv import ImageConv
from pointmvsnet_tpu_torch.models.loss import cascade_loss
from pointmvsnet_tpu_torch.ops.cost_volume import (
    depth_regression,
    photometric_confidence,
    plane_sweep_volume,
    regressed_confidence,
)
from pointmvsnet_tpu_torch.ops.geometry import (
    cam_extrinsics,
    cam_intrinsics,
    depth_hypotheses,
    pixel_grid,
    unproject_pixels,
)
from pointmvsnet_tpu_torch.ops.sampling import fetch_features
from torch_threads import one_torch_thread  # noqa: F401

import casmvsnet_reference as R

REPO = Path(__file__).resolve().parents[1]
CFG_FILE = str(REPO / "configs" / "casmvsnet_dtu.yaml")
V, H, W, NDEPTHS, PLANES, INTERVAL = 3, 64, 96, (8, 8, 8), 192, 2.65


def _cams(views, h, w, d_min=425.0, d_int=INTERVAL, num=PLANES):
    """Cam 0 at the origin looking +z, view v translated along x."""
    f = 1.2 * max(h, w)
    cams = np.zeros((1, views, 2, 4, 4), np.float32)
    for v in range(views):
        cams[0, v, 0] = np.eye(4)
        cams[0, v, 0, 0, 3] = -v * d_min * 0.012
        cams[0, v, 1, :3, :3] = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
        cams[0, v, 1, 3] = [d_min, d_int, num, d_min + (num - 1) * d_int]
    return torch.from_numpy(cams)


def _scene(seed, views=V, h=H, w=W):
    """Smooth random images (so that the views agree somewhere) and cams."""
    g = torch.Generator().manual_seed(seed)
    small = torch.rand(1, 3, h // 8 + 2, w // 8 + 2, generator=g)
    img = F.interpolate(small, (h, w + 8 * views), mode="bilinear", align_corners=False)
    frames = torch.stack([img[0, :, :, 8 * (views - v):8 * (views - v) + w]
                          for v in range(views)]).permute(0, 2, 3, 1)
    frames = (frames - frames.mean((1, 2), keepdim=True)) / frames.std((1, 2), keepdim=True)
    return frames[None].contiguous(), _cams(views, h, w)


def _cfg(dtype="float32", ndepths=NDEPTHS):
    cfg = load_cfg_from_file(CFG_FILE)
    cfg.MODEL.DTYPE = dtype
    cfg.MODEL.CASCADE.NDEPTHS = tuple(ndepths)
    return cfg


def _model_cfg(ndepths=NDEPTHS):
    return {"IMG_BASE_CHANNELS": 8, "VOL_BASE_CHANNELS": 8,
            "CASCADE": {"NDEPTHS": list(ndepths), "DEPTH_INTERVAL_RATIOS": [4.0, 2.0, 1.0]}}


def _seeded_reference(seed, images, cams):
    """The f32 reference with seeded weights (kernels uniform in ±1/√fan_in,
    BN affine drawn) and its BN statistics calibrated on the scene."""
    ref = R.build(_model_cfg())
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, t in ref.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = t
        elif ".norm." in k:
            sd[k] = (0.5 + torch.rand(t.shape, generator=g) if k.endswith("weight")
                     else 0.3 * torch.randn(t.shape, generator=g))
        elif k.endswith("bias"):
            sd[k] = 0.1 * torch.randn(t.shape, generator=g)
        else:
            fan_in = t[0].numel() if ".deconvs." not in k else t.shape[0] * t[0, 0].numel()
            sd[k] = (2 * torch.rand(t.shape, generator=g) - 1) * fan_in ** -0.5
    ref.load_state_dict(sd)
    R.calibrate_bn(ref, images, cams, PLANES)
    return ref


@pytest.fixture(scope="module")
def outputs():
    """(port, reference, reference restarted from the port's stage inputs)
    on one scene, and the port's weights; the port's U-Net biases (absent
    from the published network) set to 0.5: they cancel in the softmax."""
    images, cams = _scene(1)
    ref = _seeded_reference(2, images, cams)
    weights = R.program_weights(ref.state_dict())
    for k in weights:
        if k.endswith("convs.7.conv.bias"):
            weights[k] = torch.full_like(weights[k], 0.5)
    model = build_model(_cfg(), "cpu")
    model.load_state_dict(weights)
    with torch.no_grad():
        got = model(images, cams, num_virtual_plane=PLANES)
        want = ref(images, cams, PLANES)
        restarted = ref(images, cams, PLANES,
                        stage_inputs={s: got[f"stage{s}_input"] for s in (2, 3)})
    return got, want, restarted


# The port and the reference compute the same f32 arithmetic in other
# orders: the warp by unprojecting and projecting against the
# reference's single homography, the gather by four index_select taps
# against grid_sample. A depth of ~680 mm has an f32 ulp of 6.1e-5 mm:
# 2e-3 mm is ~30 ulps, far below what the bf16 program moves (≥ 0.1 mm).
# The confidences are sums of four f32 probabilities (ulp ≤ 6e-8): 1e-4.
BARS = {"depth": 2e-3, "confidence": 1e-4}


@pytest.mark.parametrize("key", [f"stage{s}_{m}" for s in (1, 2, 3)
                                 for m in ("depth", "confidence")])
def test_port_matches_the_reference(outputs, key):
    got, want, _ = outputs
    bar = BARS[key.split("_")[1]]
    assert got[key].shape == want[key].shape
    assert float((got[key] - want[key]).abs().max()) < bar


@pytest.mark.parametrize("s", [2, 3])
def test_a_stage_restarted_from_the_ports_input(outputs, s):
    """The reference's stage s from the port's own ``stage<s>_input``
    equals the port's stage s (the check's step numbers)."""
    got, _, restarted = outputs
    assert torch.equal(restarted[f"stage{s}_input"], got[f"stage{s}_input"])
    assert float((got[f"stage{s}_depth"] - restarted[f"stage{s}_depth"]).abs().max()) < 2e-3


def test_the_outputs_and_their_shapes(outputs):
    got, _, _ = outputs
    assert got["stage1_depth"].shape == (1, H // 4, W // 4)
    assert got["stage2_depth"].shape == (1, H // 2, W // 2)
    assert got["stage2_input"].shape == got["stage3_input"].shape == (1, H, W)
    assert got["depth"] is got["stage3_depth"] and got["confidence"] is got["stage3_confidence"]
    assert all(v.dtype == torch.float32 for v in got.values())
    # the later stages search a narrower range than the base planes span
    assert float(got["depth"].std()) > 0


# ------------------------------------------------------------ the sweep

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_pixel_sweep_equals_planes(dtype):
    """Per-pixel depths that repeat the planes over every pixel give the
    planes path's volume bit for bit."""
    g = torch.Generator().manual_seed(0)
    feats = torch.randn(2, 3, 8, 12, 4, generator=g).to(dtype)
    cams = torch.cat([_cams(3, 8, 12), _cams(3, 8, 12, d_min=500.0)])
    planes = depth_hypotheses(cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1], 16)
    planes[1, :3] = -planes[1, :3]              # non-positive depths are masked in both
    per_pixel = planes[:, :, None, None].expand(2, 16, 8, 12).contiguous()
    a = plane_sweep_volume(feats, cams, planes)
    b = plane_sweep_volume(feats, cams, per_pixel)
    assert torch.equal(a, b)


def _parent_plane_sweep_volume(feats, cams, depths):
    """``plane_sweep_volume`` as it was before it took per-pixel depths."""
    b, v, h, w, c = feats.shape
    d = depths.shape[-1]
    cams = cams.float()
    grid = pixel_grid(h, w, device=feats.device)
    pts = unproject_pixels(grid[None, None], depths.float()[..., None],
                           cam_extrinsics(cams)[:, 0, None], cam_intrinsics(cams)[:, 0, None])
    pts = pts.reshape(b, d * h * w, 3)
    ref_f = feats[:, 0].float().reshape(b, 1, h * w, c)
    ref_f = torch.where((depths > 0)[..., None, None], ref_f, 0.0)
    ref_f = ref_f.reshape(b, d * h * w, c)
    src = fetch_features(feats[:, 1:], pts, cams[:, 1:])
    mean = (ref_f + src.sum(dim=1)) / v
    sq_mean = (ref_f.square() + src.square().sum(dim=1)) / v
    return (sq_mean - mean.square()).reshape(b, d, h, w, c)


def _parent_depth_regression(prob_volume, depths):
    return torch.einsum("bdhw,bd->bhw", prob_volume, depths)


def test_pointmvsnet_coarse_path_is_the_parents():
    """dtu_wde3's coarse stage (bf16, as benchmarked) gives the same bits
    through the sweep and regression that now take per-pixel depths as
    through the code they replaced."""
    from pointmvsnet_tpu_torch.models import pointmvsnet
    from pointmvsnet_tpu_torch.utils.convert import init_params

    cfg = load_cfg_from_file(str(REPO / "configs" / "dtu_wde3.yaml"))
    cfg.MODEL.DTYPE = "bfloat16"
    model = build_model(cfg, "cpu")
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(4)))
    images, cams = _scene(5, views=3, h=64, w=128)
    kw = dict(is_flow=False, num_virtual_plane=16)
    with torch.no_grad():
        new = model(images, cams, **kw)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pointmvsnet, "plane_sweep_volume", _parent_plane_sweep_volume)
            mp.setattr(pointmvsnet, "depth_regression", _parent_depth_regression)
            old = model(images, cams, **kw)
    for k in ("coarse_depth_map", "coarse_prob_map"):
        assert torch.equal(new[k], old[k]), k


# ------------------------------------------------------- the confidence

def test_regressed_confidence_by_hand():
    """D = 6 at two pixels; the window at index j is p[j−1] … p[j+2].
    Pixel 0: p = (.5, 0, 0, 0, .1, .4), Σp·k = 0.4 + 2.0 = 2.4 → index 2,
    p1 + p2 + p3 + p4 = 0.1; the argmax (0) would take p0 + p1 + p2 =
    0.5. Pixel 1: all mass on 5 → index 5, p4 + p5 = 1.0."""
    p0 = torch.tensor([0.5, 0.0, 0.0, 0.0, 0.1, 0.4])
    p1 = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
    prob = torch.stack([p0, p1], dim=1).reshape(1, 6, 1, 2)
    got = regressed_confidence(prob)[0, 0]
    assert got.tolist() == pytest.approx([0.1, 1.0], abs=1e-6)
    assert photometric_confidence(prob)[0, 0, 0] == pytest.approx(0.5, abs=1e-6)


def test_regressed_confidence_is_the_releases():
    """Against the release's 4·avg_pool3d window and ``.long()`` index on
    random softmaxes."""
    g = torch.Generator().manual_seed(1)
    prob = torch.softmax(3 * torch.randn(2, 12, 5, 7, generator=g), dim=1)
    sum4 = 4 * F.avg_pool3d(F.pad(prob[:, None], (0, 0, 0, 0, 1, 2)), (4, 1, 1), stride=1)[:, 0]
    k = torch.arange(12, dtype=torch.float32)
    idx = torch.sum(prob * k.view(1, -1, 1, 1), 1).long().clamp(0, 11)
    want = torch.gather(sum4, 1, idx[:, None])[:, 0]
    assert torch.allclose(regressed_confidence(prob), want, atol=1e-6)


def test_depth_regression_takes_per_pixel_depths():
    g = torch.Generator().manual_seed(2)
    prob = torch.softmax(torch.randn(1, 4, 3, 5, generator=g), dim=1)
    planes = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    per_pixel = planes[:, :, None, None].expand(1, 4, 3, 5)
    assert torch.allclose(depth_regression(prob, per_pixel), depth_regression(prob, planes),
                          atol=1e-6)


# ---------------------------------------------------- model and registry

def test_casmvsnet_at_its_published_widths():
    """0.93 M parameters (the paper's count); the feature net is ImageConv's
    first eight blocks, by the same names and shapes."""
    model = build_model(load_cfg_from_file(CFG_FILE), "cpu")
    assert sum(p.numel() for p in model.parameters()) == 934_307
    assert model.crop_base == 32 and model.ndepths == (48, 32, 8)
    full = ImageConv(8).state_dict()
    for k, t in ImageConv(8, levels=3).state_dict().items():
        assert full[k].shape == t.shape
    assert len(ImageConv(8, levels=3).blocks) == 8 and len(ImageConv(8).blocks) == 11
    three = {k for k in model.state_dict() if k.startswith("features.img_conv.")}
    assert three == {f"features.img_conv.{k}" for k in ImageConv(8, levels=3).state_dict()}


def test_casmvsnet_refuses_an_input_off_its_grid():
    model = build_model(_cfg(), "cpu")
    images, cams = _scene(1, h=48, w=80)
    with pytest.raises(ValueError, match="divisible by 32"):
        model(images, cams)


def test_cascade_loss_and_metrics_by_hand():
    """GT 1 mm above every stage's depth (smooth-L1 0.5) and 3 mm above on
    the masked-out half: each stage's loss 0.5, the total 0.5 · (0.5 + 1 +
    2); the share within one interval (2.65 mm) is 1."""
    preds = {f"stage{s}_depth": torch.full((1, H // k, W // k), 600.0)
             for s, k in ((1, 4), (2, 2), (3, 1))}
    gt = torch.full((1, H, W, 1), 601.0)
    gt[:, :, W // 2:] = 0.0
    cams = _cams(V, H, W)
    losses = cascade_loss(preds, gt, cams)
    for s in (1, 2, 3):
        assert float(losses[f"stage{s}_loss"]) == pytest.approx(0.5)
    assert float(losses["total_loss"]) == pytest.approx(1.75)
    metrics = build_metric_fn(_cfg())(preds, gt, cams)
    assert set(metrics) == {f"<{t}_pct_stage{s}" for t in (1, 3) for s in (1, 2, 3)}
    assert all(float(v) == pytest.approx(1.0) for v in metrics.values())


# ------------------------------------------------- the two reference copies

def test_the_benchmarks_reference_copy_agrees(outputs):
    """``perfbench/reference/casmvsnet.py`` gives this file's outputs on the
    same weights and inputs."""
    spec = importlib.util.spec_from_file_location(
        "bench_casmvsnet", REPO / "perfbench" / "reference" / "casmvsnet.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    images, cams = _scene(1)
    mine = _seeded_reference(2, images, cams)
    theirs = bench.build(_model_cfg())
    theirs.load_state_dict(mine.state_dict())
    theirs.eval()
    with torch.no_grad():
        a, b = mine(images, cams, PLANES), theirs(images, cams, PLANES)
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


# -------------------------------------------- Predictor and the test CLI

def _tree(tmp_path, h, w):
    from pointmvsnet_tpu_torch.dataset.synthetic import make_synthetic_dtu
    root = str(tmp_path / "tree")
    make_synthetic_dtu(root, scans=[1], num_views=V, height=h, width=w, num_depth=PLANES,
                       depth_interval=2.5, layout="eval")
    return root


CASES = {
    # name: (config file, overrides, crop base, exported suffixes)
    "casmvsnet": (CFG_FILE, ["MODEL.DTYPE", "float32", "MODEL.CASCADE.NDEPTHS", "(8, 8, 8)"],
                  32, {"init", "prob"}),
    "pointmvsnet": (None, ["MODEL.IMG_BASE_CHANNELS", "4", "MODEL.VOL_BASE_CHANNELS", "4",
                           "MODEL.TEST.IMG_SCALES", "(0.25,)", "MODEL.TEST.INTER_SCALES",
                           "(0.75,)", "DATA.TEST.NUM_VIRTUAL_PLANE", "16"],
                    64, {"init", "flow1", "prob"}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_and_predictor_export(tmp_path, name):
    """The test CLI on a 96×160 eval tree crops to the model's base (96×160
    for the cascade, 64×128 for Point-MVSNet), writes the model's maps,
    and its depth and confidence are what ``Predictor`` returns on the
    same view."""
    from pointmvsnet_tpu_torch import test
    from pointmvsnet_tpu_torch.dataset.io import load_cam, load_pfm, read_image, read_png
    from pointmvsnet_tpu_torch.predictor import Predictor

    cfg_file, opts, base, suffixes = CASES[name]
    root = _tree(tmp_path, 96, 160)
    opts = opts + ["DATA.TEST.ROOT_DIR", root, "DATA.TEST.NUM_VIEW", str(V),
                   "DATA.TEST.IMG_HEIGHT", "96", "DATA.TEST.IMG_WIDTH", "160"]
    summary, depth_dir = test.main(["--device", "cpu"] + (["--cfg", cfg_file] if cfg_file else [])
                                   + ["OUTPUT_DIR", str(tmp_path / "out")] + opts)
    assert summary["maps"] == V
    stems = sorted(glob.glob(os.path.join(depth_dir, "scan1", "*.png")))
    assert len(stems) == V
    found = {os.path.basename(p)[9:-4] for p in glob.glob(os.path.join(depth_dir, "scan1",
                                                                       "00000000_*.pfm"))}
    assert found == suffixes
    cfg = get_default_cfg()
    if cfg_file:
        cfg.merge_from_file(cfg_file)
    cfg.merge_from_list(opts)
    pred = Predictor(cfg, device="cpu")
    views = [0, 1, 2]
    images = np.stack([read_image(os.path.join(root, "Eval", "scan1", "images", f"{v:08d}.jpg"))
                       for v in views])
    cams = np.stack([load_cam(os.path.join(root, "Eval", "scan1", "cams", f"{v:08d}_cam.txt"),
                              cfg.DATA.TEST.INTERVAL_SCALE, cfg.DATA.TEST.NUM_VIRTUAL_PLANE)
                     for v in views])
    out = pred(images, cams)
    final = "flow1" if "flow1" in suffixes else "init"
    depth = load_pfm(os.path.join(depth_dir, "scan1", f"00000000_{final}.pfm"))
    prob = load_pfm(os.path.join(depth_dir, "scan1", "00000000_prob.pfm"))
    assert read_png(stems[0]).shape[:2] == (96 // base * base, 160 // base * base)
    assert out["depth"].shape == depth.shape
    np.testing.assert_allclose(out["depth"], depth, rtol=0, atol=1e-3)
    np.testing.assert_allclose(out["confidence"], prob, rtol=0, atol=1e-5)


def test_entry_points_ask_the_model():
    """No entry point branches on MODEL.NAME: Predictor and the test CLI
    take the model's options, keys, maps and crop base."""
    for f in ("predictor.py", "test.py", "utils/eval_file_logger.py", "parallel/train_step.py"):
        src = (REPO / "pointmvsnet_tpu_torch" / f).read_text()
        assert "cfg.MODEL.NAME" not in src and "base=64" not in src, f
    model = build_model(get_default_cfg(), "cpu")
    assert model.crop_base == 64
    assert model.result_keys({"coarse_depth_map": 0, "flow1": 0, "flow2": 0,
                              "flow2_input": 0}) == ("flow2", "coarse_prob_map")
    assert list(model.export_maps({"coarse_depth_map": 0, "flow1": 0, "flow1_input": 0})) == \
        ["init", "flow1", "prob"]
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "mvsnet"
    assert build_model(cfg, "cpu").eval_kwargs(cfg)["is_flow"] is False
