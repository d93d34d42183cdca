"""PointFlow's fused fetch (``ops/sampling.py::point_fetch``): the CUDA
kernel's argument checks and the rule that picks it, on the CPU. The kernel
itself runs only on the card, where ``chip_smoke.py --phases point-fetch``
holds it to ``point_fetch_plain`` bit for bit; here ``point_fetch_plain``
stands in for it inside the model, which must then give the composition's
bits."""

import re
from types import SimpleNamespace

import pytest
import torch

from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
from pointmvsnet_tpu_torch.models.pointmvsnet import PointMVSNet
from pointmvsnet_tpu_torch.ops import _cuda, sampling
from pointmvsnet_tpu_torch.ops.sampling import (
    check_fetch_args,
    fetch_kernel_applies,
    point_fetch_cuda,
    point_fetch_plain,
)
from torch_threads import one_torch_thread  # noqa: F401

B, V, G, H, W = 2, 3, 5, 8, 12


def same_bits(a, b):
    it = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.shape == b.shape and torch.equal(a.view(it), b.view(it))


def fetch_args(widths=(8, 16, 32), dtype=torch.bfloat16, seed=0):
    """Kernel arguments at an (H, W) flow grid, level l at (H, W) / 2^l."""
    gen = torch.Generator().manual_seed(seed)
    n = H * W
    levels = [torch.rand(B, V, H >> l, W >> l, c, generator=gen).to(dtype)
              for l, c in enumerate(widths)]
    uv = torch.rand(B, V - 1, G * n, 2, generator=gen) * torch.tensor([W + 4, H + 4]) - 2
    z = torch.rand(B, V - 1, G * n, generator=gen) - 0.2
    refs = [torch.rand(B, n, c, generator=gen) for c in widths]
    hyp = torch.rand(B, G, n, generator=gen) - 0.1
    return levels, uv, z, refs, hyp


def scene_points():
    cams = torch.from_numpy(make_scene_batch(B, V, 32, 48, 16, seed=3)[1])
    pts = torch.rand(B, G * H * W, 3) * 100 + torch.tensor([0.0, 0.0, 400.0])
    return pts, cams[:, 1:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_the_composition(dtype):
    """``point_fetch_plain`` on the projection is the model's composition
    (``fetch_features_perlevel`` and ``view_variance``) cast to the levels'
    dtype, bit for bit."""
    levels, _, _, refs, hyp = fetch_args(dtype=dtype)
    pts, src_cams = scene_points()
    s1, s2 = sampling.fetch_features_perlevel([f[:, 1:] for f in levels], pts, src_cams)
    want = sampling.view_variance(refs, hyp, s1, s2, V)
    got = point_fetch_plain(levels, *sampling._project(pts, src_cams), refs, hyp)
    assert got.dtype == dtype and same_bits(got, want.to(dtype))


@pytest.mark.parametrize("kernel", [False, True])
def test_point_fetch_takes_the_kernel_where_the_rule_holds(monkeypatch, kernel):
    """``point_fetch`` hands the projection to ``point_fetch_cuda`` where
    ``fetch_kernel_applies`` holds (here ``point_fetch_plain`` stands in for
    it), else to ``point_fetch_plain``: the composition's bits in the
    levels' dtype either way."""
    levels, _, _, refs, hyp = fetch_args()
    pts, src_cams = scene_points()
    calls = []

    def stand_in(*args):
        calls.append(args)
        return point_fetch_plain(*args)

    monkeypatch.setattr(sampling, "fetch_kernel_applies", lambda *t: kernel)
    monkeypatch.setattr(sampling, "point_fetch_cuda", stand_in)
    got = sampling.point_fetch(levels, pts, src_cams, refs, hyp)
    s1, s2 = sampling.fetch_features_perlevel([f[:, 1:] for f in levels], pts, src_cams)
    want = sampling.view_variance(refs, hyp, s1, s2, V)
    assert len(calls) == int(kernel)
    assert got.dtype == torch.bfloat16 and same_bits(got, want.to(got.dtype))


@pytest.mark.parametrize("widths,ch", [((8, 16, 32), 8), ((4, 8, 16), 4), ((2, 4, 8), 2),
                                       ((3, 6, 12), 1), ((8,), 8), ((16, 8, 24, 40), 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_fetch_args_picks_the_widest_chunk(widths, ch, dtype):
    assert check_fetch_args(*fetch_args(widths, dtype)) == ch


def test_check_fetch_args_narrows_the_chunk_to_the_alignment():
    """A level that starts 2 elements into its storage takes 2 channels a
    thread; one reference sample 4 floats in, 4."""
    levels, uv, z, refs, hyp = fetch_args()
    shifted = torch.empty(levels[1].numel() + 2, dtype=levels[1].dtype)[2:]
    shifted.copy_(levels[1].reshape(-1))
    assert check_fetch_args([levels[0], shifted.view(levels[1].shape), levels[2]], uv, z,
                            refs, hyp) == 2
    ref = torch.empty(refs[0].numel() + 4)[4:].view(refs[0].shape)
    assert check_fetch_args(levels, uv, z, [ref, *refs[1:]], hyp) == 4


def _bad(case):
    levels, uv, z, refs, hyp = fetch_args()
    if case == "level dtype":
        levels = [f.half() for f in levels]
    elif case == "mixed level dtypes":
        levels = [levels[0].float(), *levels[1:]]
    elif case == "uv dtype":
        uv = uv.double()
    elif case == "ref dtype":
        refs = [refs[0].bfloat16(), *refs[1:]]
    elif case == "uv shape":
        uv = uv[:, :, 1:].contiguous()
    elif case == "z views":
        z = z[:, :1].contiguous()
    elif case == "hyp batch":
        hyp = hyp[:1].contiguous()
    elif case == "level batch":
        levels = [levels[0], levels[1][:1].contiguous(), levels[2]]
    elif case == "level rank":
        levels = [levels[0][0], *levels[1:]]
    elif case == "one view":
        levels = [f[:, :1].contiguous() for f in levels]
        uv, z = uv[:, :0].contiguous(), z[:, :0].contiguous()
    elif case == "level contiguity":
        levels = [levels[0].transpose(2, 3).contiguous().transpose(2, 3), *levels[1:]]
    elif case == "uv contiguity":
        uv = uv.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "ref contiguity":
        refs = [refs[0].transpose(0, 1).contiguous().transpose(0, 1), *refs[1:]]
    elif case == "ref channels":
        refs = [refs[0][..., :4].contiguous(), *refs[1:]]
    elif case == "no channels":
        levels = [levels[0][..., :0].contiguous(), *levels[1:]]
        refs = [refs[0][..., :0].contiguous(), *refs[1:]]
    elif case == "no levels":
        levels, refs = [], []
    elif case == "five levels":
        levels, refs = levels + levels[:2], refs + refs[:2]
    elif case == "refs per level":
        refs = refs[:2]
    elif case == "view past 2^31":
        levels = [torch.empty(B, V, 2 ** 16, 2 ** 12, 8, dtype=torch.bfloat16, device="meta"),
                  *levels[1:]]
    return levels, uv, z, refs, hyp


@pytest.mark.parametrize("case,match", [
    ("level dtype", "float32 or bfloat16"), ("mixed level dtypes", "level 1"),
    ("uv dtype", "uv must be contiguous float32"),
    ("ref dtype", r"ref_samples\[0\] must"), ("uv shape", "uv must"), ("z views", "z must"),
    ("hyp batch", "hyp_depth must be"), ("level batch", "level 1"), ("level rank", "levels must"),
    ("one view", "V ≥ 2"), ("level contiguity", "level 0 must be contiguous"),
    ("uv contiguity", "uv must be contiguous"), ("ref contiguity", r"ref_samples\[0\] must"),
    ("ref channels", r"ref_samples\[0\] must"), ("no channels", "C ≥ 1"),
    ("no levels", "1 to 4 levels"), ("five levels", "1 to 4 levels"),
    ("refs per level", "a reference sample for each"),
    ("view past 2^31", r"past the kernel's 2\^31")])
def test_check_fetch_args_raises(case, match):
    with pytest.raises(ValueError, match=match):
        check_fetch_args(*_bad(case))


def test_point_fetch_cuda_takes_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        point_fetch_cuda(*fetch_args())


@pytest.mark.parametrize("source", sorted(_cuda.SIGNATURES))
def test_the_c_entries_take_their_signatures(source):
    """Each C entry of ``csrc/<source>.cu`` takes the arguments its
    ``SIGNATURES`` entry gives ctypes: a pointer for each ``*`` parameter,
    an int for each ``int``, in order and no more."""
    text = (_cuda.CSRC / f"{source}.cu").read_text()
    for entry, argtypes in _cuda.SIGNATURES[source].items():
        decl = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
        assert decl, entry
        params = [p.strip() for p in decl.group(1).split(",")]
        got = [_cuda._P if "*" in p else _cuda._I for p in params]
        assert all("*" in p or p.split()[0] == "int" for p in params), params
        assert got == argtypes, (entry, params)


def _tensor(cuda: bool, grad: bool):
    return SimpleNamespace(is_cuda=cuda, requires_grad=grad)


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference_mode"])
def test_dispatch_rule(mode):
    """The kernel where every input is on CUDA and no gradient is needed;
    the composition on the CPU, and under autograd where an input requires
    a gradient."""
    ctx = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
           "inference_mode": torch.inference_mode}[mode]
    with ctx():
        assert not fetch_kernel_applies(_tensor(False, False), _tensor(True, False))
        assert not fetch_kernel_applies(_tensor(False, False))
        assert fetch_kernel_applies(_tensor(True, False), _tensor(True, False))
        assert fetch_kernel_applies(_tensor(True, False), _tensor(True, True)) == (
            mode != "grad")
        t = torch.zeros(2, requires_grad=mode != "inference_mode")
        assert not fetch_kernel_applies(t)


def tiny_model(dtype, chunk_rows=0):
    torch.manual_seed(0)
    model = PointMVSNet(img_base_channels=4, vol_base_channels=4, edge_channels=(8, 8),
                        flow_channels=(8, 1), dtype=dtype, flow_chunk_rows=chunk_rows)
    for mod in model.modules():
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            mod.running_mean.uniform_(-0.2, 0.2)
            mod.running_var.uniform_(0.5, 1.5)
    return model.eval()


def forward(model):
    images, cams, _ = make_scene_batch(1, 3, 64, 64, 16, seed=5)
    with torch.inference_mode():
        return model(torch.tensor(images), torch.tensor(cams), img_scales=(0.25, 0.5),
                     inter_scales=(0.75, 0.375), num_virtual_plane=16)


def test_the_cpu_takes_the_composition(monkeypatch):
    def kernel(*args):
        raise AssertionError("point_fetch_cuda ran on CPU tensors")
    monkeypatch.setattr(sampling, "point_fetch_cuda", kernel)
    assert torch.isfinite(forward(tiny_model(torch.float32))["flow2"]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk_rows", [0, 8])
def test_kernel_path_gives_the_compositions_bits(monkeypatch, dtype, chunk_rows):
    """The model's kernel path, with ``point_fetch_plain`` standing in for
    the kernel, gives the composition's depth maps bit for bit, unbanded and
    in row bands (flow2's 32 rows in four bands of 8 with their halo): the
    projection, the reference samples at the band's rows, the hypothesis
    depths and the levels' dtype (the first EdgeConv's) reach the kernel as the
    composition uses them. One call per PointFlow call."""
    want = forward(tiny_model(dtype, chunk_rows))
    calls = []

    def stand_in(levels, uv, z, refs, hyp):
        calls.append(levels[0].dtype)
        return point_fetch_plain(levels, uv, z, refs, hyp)

    monkeypatch.setattr(sampling, "fetch_kernel_applies", lambda *t: True)
    monkeypatch.setattr(sampling, "point_fetch_cuda", stand_in)
    got = forward(tiny_model(dtype, chunk_rows))
    assert calls == [dtype] * (1 + (4 if chunk_rows else 1))
    for key in ("flow1", "flow2"):
        assert same_bits(got[key], want[key])
