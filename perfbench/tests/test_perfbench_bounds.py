"""The copied bound arithmetic against the program's on-card smoke test,
on fixed shapes; the operation counts of the cells."""

import importlib.util
from pathlib import Path

import pytest
import torch

from perfbench.counts import bounds, flops

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_bounds", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("h,w", [(128, 160), (256, 320), (512, 640), (1024, 1920), (5, 37)])
def test_knn_bound(smoke, h, w):
    assert bounds.knn_bound(h, w, 5, 16, 5) == smoke.knn_bound(h, w)
    assert bounds.bound_ms(*bounds.knn_bound(h, w, 5, 16, 5)) == smoke.bound_ms(
        *smoke.knn_bound(h, w))


@pytest.mark.parametrize("dtype,f", [(torch.bfloat16, 32), (torch.float32, 64)])
def test_mwm_bound(smoke, dtype, f):
    g, h, w = 5, 12, 20
    gen = torch.Generator().manual_seed(f)
    z = torch.randn(1, g * h * w, f, generator=gen).to(dtype)
    mask = torch.randint(-2 ** 31, 2 ** 31 - 1, (1, 4, g, h, w), generator=gen,
                         dtype=torch.int64).to(torch.int32)
    pop = sum(int(((mask.long() >> s) & 1).sum()) for s in range(32))
    got = bounds.mwm_bound(g * h * w, f, z.element_size(), mask.numel(), pop)
    assert got == smoke.mwm_bound(z, mask)
    assert bounds.bound_ms(*got) == smoke.bound_ms(*smoke.mwm_bound(z, mask))


def test_peaks_match_the_smoke_test(smoke):
    assert bounds.HBM_BYTES_PER_S == smoke.HBM_BYTES_PER_S
    assert bounds.F32_FLOPS == smoke.F32_FLOPS


def test_forward_flops_by_dtype():
    cfg = dict(IMG_BASE_CHANNELS=8, VOL_BASE_CHANNELS=8, EDGE_CHANNELS=[32, 32, 64],
               FLOW_CHANNELS=[64, 64, 16, 1], FLOW_INTERVAL_M=2, KNN=16, KNN_WINDOW=5)
    kw = dict(is_flow=True, img_scales=(0.25, 0.5, 1.0), inter_scales=(0.75, 0.375, 0.1875),
              num_virtual_plane=16)
    bf = flops.forward_flops(cfg, "bfloat16", 3, 64, 128, kw)
    f32 = flops.forward_flops(cfg, "float32", 3, 64, 128, kw)
    assert set(bf) == {"bfloat16", "float32"} and set(f32) == {"float32"}
    assert bf["bfloat16"] + bf["float32"] == pytest.approx(f32["float32"])
    # one EdgeConv matmul pair at flow3: 2 · N · (2 · C) · F for z and the centre term
    assert bf["bfloat16"] > 2 * 5 * 64 * 128 * 56 * 32 * 2
