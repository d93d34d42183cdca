"""The plane sweep's cost-volume kernel (``ops/cost_volume.py``): the CUDA
kernel's argument checks and the rule that picks it, on the CPU. The kernel
itself runs only on the card, where ``chip_smoke.py --phases sweep`` holds
it to ``plane_sweep_plain`` bit for bit; here ``plane_sweep_plain`` stands
in for it inside ``plane_sweep_volume`` and the two models, which must then
give the bits of the composition the sweep had before the kernel, cast to
the features' dtype."""

import re
from types import SimpleNamespace

import pytest
import torch

from pointmvsnet_tpu_torch.config import load_cfg_from_file
from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
from pointmvsnet_tpu_torch.models import build_model
from pointmvsnet_tpu_torch.models.pointmvsnet import PointMVSNet
from pointmvsnet_tpu_torch.ops import _cuda, cost_volume, sampling
from pointmvsnet_tpu_torch.ops.cost_volume import (
    check_sweep_args,
    plane_sweep_cuda,
    plane_sweep_plain,
    plane_sweep_volume,
)
from pointmvsnet_tpu_torch.ops.geometry import (
    cam_extrinsics,
    cam_intrinsics,
    depth_hypotheses,
    pixel_grid,
    unproject_pixels,
)
from pointmvsnet_tpu_torch.ops.sampling import fetch_features
from pointmvsnet_tpu_torch.utils.convert import init_params
from torch_threads import one_torch_thread  # noqa: F401

B, V, D, H, W = 2, 3, 6, 8, 12
ROOT = _cuda.CSRC.parents[1]


def same_bits(a, b):
    it = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.view(it), b.view(it))


def composition(feats, cams, depths):
    """``plane_sweep_volume`` as it was before the kernel: the projection,
    ``fetch_features``, the reference view's map and the variance, f32."""
    b, v, h, w, c = feats.shape
    d = depths.shape[1]
    cams = cams.float()
    grid = pixel_grid(h, w, device=feats.device)
    per_pt = (depths.float()[..., None] if depths.dim() == 2
              else depths.float().reshape(b, d, h * w))
    pts = unproject_pixels(grid[None, None], per_pt, cam_extrinsics(cams)[:, 0, None],
                           cam_intrinsics(cams)[:, 0, None]).reshape(b, d * h * w, 3)
    ref_f = feats[:, 0].float().reshape(b, 1, h * w, c)
    ref_f = torch.where((per_pt > 0)[..., None], ref_f, 0.0).reshape(b, d * h * w, c)
    src = fetch_features(feats[:, 1:], pts, cams[:, 1:])
    mean = (ref_f + src.sum(dim=1)) / v
    sq_mean = (ref_f.square() + src.square().sum(dim=1)) / v
    return (sq_mean - mean.square()).reshape(b, d, h, w, c)


def sweep_inputs(c=8, dtype=torch.bfloat16, per_pixel=False, seed=0, views=V):
    """Features, cameras at feature resolution and depths over the scene's
    range; a few planes (or pixels' depths) negative or zero, which mask
    the reference view, and some hypotheses far from the scene, whose
    source-view taps fall outside the image."""
    gen = torch.Generator().manual_seed(seed)
    cams = torch.from_numpy(make_scene_batch(B, views, H, W, D, seed=seed)[1])
    feats = torch.randn(B, views, H, W, c, generator=gen).to(dtype)
    planes = depth_hypotheses(cams[:, 0, 1, 3, 0], cams[:, 0, 1, 3, 1] * 40, D)
    planes[1, :2] = torch.tensor([-3.0, 0.0])
    if not per_pixel:
        return feats, cams, planes
    depths = planes[:, :, None, None] * (1 + 0.3 * torch.rand(B, D, H, W, generator=gen))
    depths[0, 0, 0, :4] = torch.tensor([-1.0, 0.0, -0.0, 5.0])
    return feats, cams, depths


def kernel_args(feats, cams, depths):
    """``plane_sweep_cuda``'s arguments as ``plane_sweep_volume`` makes them."""
    b, v, h, w, c = feats.shape
    per_pt = cost_volume._depth_per_point(depths, h, w)
    pts = unproject_pixels(pixel_grid(h, w)[None, None], per_pt,
                           cam_extrinsics(cams)[:, 0, None], cam_intrinsics(cams)[:, 0, None])
    uv, z = sampling._project(pts.reshape(b, -1, 3), cams[:, 1:])
    return feats, uv.contiguous(), z.contiguous(), depths.float().contiguous()


@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_cpu_takes_the_composition(dtype, per_pixel):
    """On the CPU ``plane_sweep_volume`` is the composition it was, cast to
    the features' dtype (``plane_sweep_plain``)."""
    feats, cams, depths = sweep_inputs(dtype=dtype, per_pixel=per_pixel)
    got = plane_sweep_volume(feats, cams, depths)
    assert got.dtype == dtype and same_bits(got, composition(feats, cams, depths).to(dtype))


@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_sweep_takes_the_kernel_where_the_rule_holds(monkeypatch, dtype, per_pixel):
    """``plane_sweep_volume`` hands the projection to ``plane_sweep_cuda``
    where ``fetch_kernel_applies`` holds (here ``plane_sweep_plain`` stands
    in for it): the composition's bits in the features' dtype, for planes
    and per-pixel depths."""
    feats, cams, depths = sweep_inputs(dtype=dtype, per_pixel=per_pixel, seed=1)
    calls = []

    def stand_in(*args):
        calls.append(args)
        return plane_sweep_plain(*args)

    monkeypatch.setattr(cost_volume, "fetch_kernel_applies", lambda *t: True)
    monkeypatch.setattr(cost_volume, "plane_sweep_cuda", stand_in)
    got = plane_sweep_volume(feats, cams, depths)
    assert len(calls) == 1 and got.dtype == dtype and got.shape == (B, D, H, W, 8)
    assert same_bits(got, composition(feats, cams, depths).to(dtype))
    check_sweep_args(*calls[0])
    assert calls[0][3].shape == depths.shape


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference_mode"])
def test_the_rule_under_autograd(monkeypatch, mode):
    """Features that require a gradient take the kernel under ``no_grad``
    and ``inference_mode`` and the composition with autograd on; the rule
    is ``fetch_kernel_applies``, with the CUDA test left out here."""
    feats, cams, depths = sweep_inputs(dtype=torch.float32)
    feats.requires_grad_(True)
    calls = []

    def on_card(*tensors):
        return sampling.fetch_kernel_applies(*[SimpleNamespace(is_cuda=True,
                                                               requires_grad=t.requires_grad)
                                               for t in tensors])

    monkeypatch.setattr(cost_volume, "fetch_kernel_applies", on_card)
    monkeypatch.setattr(cost_volume, "plane_sweep_cuda",
                        lambda *a: calls.append(a) or plane_sweep_plain(*a))
    ctx = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
           "inference_mode": torch.inference_mode}[mode]
    with ctx():
        got = plane_sweep_volume(feats, cams, depths)
    assert len(calls) == int(mode != "grad")
    assert got.requires_grad == (mode == "grad")


@pytest.mark.parametrize("c,ch", [(32, 8), (16, 8), (8, 8), (12, 4), (6, 2), (3, 1), (1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_sweep_args_picks_the_widest_chunk(c, ch, dtype):
    assert check_sweep_args(*kernel_args(*sweep_inputs(c=c, dtype=dtype))) == ch


def test_check_sweep_args_narrows_the_chunk_to_the_alignment():
    """Features that start 2 elements into their storage take 2 channels a
    thread."""
    feats, uv, z, depths = kernel_args(*sweep_inputs(c=16))
    shifted = torch.empty(feats.numel() + 2, dtype=feats.dtype)[2:]
    shifted.copy_(feats.reshape(-1))
    assert check_sweep_args(shifted.view(feats.shape), uv, z, depths) == 2


def _bad(case):
    feats, uv, z, depths = kernel_args(*sweep_inputs())
    if case == "feats dtype":
        feats = feats.half()
    elif case == "feats rank":
        feats = feats[0]
    elif case == "no channels":
        feats = feats[..., :0].contiguous()
    elif case == "one view":
        feats, uv, z = feats[:, :1].contiguous(), uv[:, :0].contiguous(), z[:, :0].contiguous()
    elif case == "feats contiguity":
        feats = feats.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "view past 2^31":
        feats = torch.empty(1, 2, 2 ** 16, 2 ** 12, 8, dtype=torch.bfloat16, device="meta")
    elif case == "batch past 65535":
        feats = torch.empty(65536, 2, 1, 1, 8, dtype=torch.bfloat16, device="meta")
    elif case == "depths rank":
        depths = depths[..., None]
    elif case == "depths batch":
        depths = depths[:1].contiguous()
    elif case == "depths grid":
        depths = depths[:, :, None, None].expand(B, D, H, W - 1).contiguous()
    elif case == "depths dtype":
        depths = depths.double()
    elif case == "depths contiguity":
        depths = depths.t().contiguous().t()
    elif case == "uv dtype":
        uv = uv.double()
    elif case == "uv shape":
        uv = uv[:, :, 1:].contiguous()
    elif case == "uv contiguity":
        uv = uv.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "z views":
        z = z[:, :1].contiguous()
    elif case == "z contiguity":
        z = z.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "uv alignment":
        uv = torch.empty(uv.numel() + 1)[1:].view(uv.shape)
    elif case == "threads past 2^31":
        feats = torch.empty(1, 2, 2 ** 10, 2 ** 10, 8, dtype=torch.bfloat16)
        depths = torch.empty(1, 2 ** 11)
        uv = torch.empty(1, 1, 2 ** 31, 2, device="meta")
        z = torch.empty(1, 1, 2 ** 31, device="meta")
    return feats, uv, z, depths


@pytest.mark.parametrize("case,match", [
    ("feats dtype", "float32 or bfloat16"), ("feats rank", r"\(B, V, h, w, C ≥ 1\)"),
    ("no channels", r"C ≥ 1"), ("one view", "V ≥ 2"), ("batch past 65535", "B ≤ 65535"),
    ("feats contiguity", "feats must be contiguous"), ("view past 2^31", r"past the kernel's 2\^31"),
    ("depths rank", "depths must be"), ("depths batch", "depths must be"),
    ("depths grid", "depths must be"), ("depths dtype", "depths must be contiguous float32"),
    ("depths contiguity", "depths must be contiguous"), ("uv dtype", "uv must be"),
    ("uv shape", "uv must be"), ("uv contiguity", "uv must be contiguous"),
    ("z views", "z must be"), ("z contiguity", "z must be contiguous"),
    ("uv alignment", "aligned to 8 bytes"), ("threads past 2^31", r"threads: past")])
def test_check_sweep_args_raises(case, match):
    with pytest.raises(ValueError, match=match):
        check_sweep_args(*_bad(case))


def test_plane_sweep_cuda_takes_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        plane_sweep_cuda(*kernel_args(*sweep_inputs()))


def test_the_library_hash_covers_the_shared_headers(monkeypatch, tmp_path):
    """An edit of a shared ``.cuh`` rebuilds every source: the library's
    name changes with the header's bytes, and with the source's."""
    for f in ("plane_sweep.cu", "bilinear_variance.cuh"):
        (tmp_path / f).write_bytes((_cuda.CSRC / f).read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    first = _cuda.lib_path("plane_sweep")
    (tmp_path / "bilinear_variance.cuh").write_text("// edited\n")
    second = _cuda.lib_path("plane_sweep")
    (tmp_path / "plane_sweep.cu").write_text("// edited\n")
    assert len({first, second, _cuda.lib_path("plane_sweep")}) == 3


def test_the_sweep_kernel_is_not_the_fetch_kernel():
    """The sweep's kernels are named ``plane_sweep*`` and never contain
    ``point_fetch``, which the fetch's launch and roofline readers match."""
    kernels = re.findall(r"\n(\w+)\(const __grid_constant__",
                         (_cuda.CSRC / "plane_sweep.cu").read_text())
    assert kernels == ["plane_sweep_kernel"]
    assert "__global__" not in (_cuda.CSRC / "bilinear_variance.cuh").read_text()


# ------------------------------------------------------------- the models

def _pointmvsnet(dtype):
    torch.manual_seed(0)
    model = PointMVSNet(img_base_channels=4, vol_base_channels=4, edge_channels=(8, 8),
                        flow_channels=(8, 1), dtype=dtype)
    for mod in model.modules():
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            mod.running_mean.uniform_(-0.2, 0.2)
            mod.running_var.uniform_(0.5, 1.5)
    return model.eval()


def _pointmvsnet_forward(model):
    images, cams, _ = make_scene_batch(1, 3, 64, 64, 16, seed=5)
    with torch.inference_mode():
        return model(torch.tensor(images), torch.tensor(cams), img_scales=(0.25, 0.5),
                     inter_scales=(0.75, 0.375), num_virtual_plane=16)


def _casmvsnet_forward(dtype):
    cfg = load_cfg_from_file(str(ROOT / "configs" / "casmvsnet_dtu.yaml"))
    cfg.MODEL.DTYPE = dtype
    cfg.MODEL.CASCADE.NDEPTHS = (8, 8, 8)
    model = build_model(cfg, "cpu")
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(3)))
    images, cams, _ = make_scene_batch(1, 3, 64, 96, 192, depth_interval=2.65, seed=6)
    with torch.inference_mode():
        return model(torch.tensor(images), torch.tensor(cams), num_virtual_plane=192)


@pytest.mark.parametrize("model", ["pointmvsnet", "casmvsnet"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_path_gives_the_models_bits(monkeypatch, model, dtype):
    """Each model's kernel path, with ``plane_sweep_plain`` standing in for
    the kernel, gives the composition's maps bit for bit: the volume in the
    features' dtype is what the U-Net's first conv made of the f32 volume.
    Point-MVSNet's coarse sweep takes planes (one call); CasMVSNet's stage 1
    planes and stages 2-3 per-pixel depths (three calls)."""
    if model == "pointmvsnet":
        def run():
            return _pointmvsnet_forward(_pointmvsnet(dtype))
        keys = ("coarse_depth_map", "coarse_prob_map", "flow1", "flow2")
    else:
        def run():
            return _casmvsnet_forward(str(dtype)[6:])
        keys = tuple(f"stage{s}_{m}" for s in (1, 2, 3) for m in ("depth", "confidence"))
    want = run()
    calls = []

    def stand_in(feats, uv, z, depths):
        calls.append((feats.dtype, depths.dim()))
        return plane_sweep_plain(feats, uv, z, depths)

    monkeypatch.setattr(cost_volume, "fetch_kernel_applies", lambda *t: True)
    monkeypatch.setattr(cost_volume, "plane_sweep_cuda", stand_in)
    got = run()
    assert calls == ([(dtype, 2)] if model == "pointmvsnet"
                     else [(dtype, 2), (dtype, 4), (dtype, 4)])
    for key in keys:
        assert same_bits(got[key], want[key]), key
