"""The fused fetch's readers (``metrics/point_fetch_launches.py``,
``metrics/point_fetch_roofline.py``) on hand-built records: launches and
the share of the roofline per map where ``point_fetch*`` kernels ran, and
nothing where none did (the parent's program). The bound counts the
fetch's bytes at the cell's flow grids, as the on-card smoke test counts
them from the kernel's arguments."""

import importlib.util
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.counts import bounds
from perfbench.trace import Record

LAUNCHES = harness.load_metric("point_fetch_launches.forward")
ROOFLINE = harness.load_metric("point_fetch_roofline.forward")
FETCH = "void (anonymous namespace)::point_fetch_kernel<__nv_bfloat16, 8>(Params)"
ROOT = Path(__file__).resolve().parents[2]


def record(fetch_us, maps=2):
    ops = [("kernel", "void at::native::vectorized_gather_kernel<16, long>", 0.0, 500.0)]
    for m in range(maps):
        ops += [("kernel", FETCH, 1000.0 * m + 10 * i, us) for i, us in enumerate(fetch_us)]
    return Record(window_s=1.0, items=maps, ops=ops, gaps=[], busy_s=0.5)


@pytest.mark.parametrize("cell", ["tt-forward", "dtu-serve"])
def test_the_readers_per_map(cell):
    run = harness.Run(harness.load_cell(cell), None, record([300.0, 1200.0, 4800.0]))
    assert LAUNCHES.read(run) == 3.0
    b = run.cell.config["eval"]
    least = sum(bounds.bound_ms(*ROOFLINE.fetch_bound(5, 5, int(b["height"] * s),
                                                     int(b["width"] * s), (8, 16, 32), 2))[0]
                for s in b["img_scales"])
    assert ROOFLINE.read(run) == pytest.approx(100.0 * least / 6.3)
    assert 0 < ROOFLINE.read(run) < 100


def test_the_bound_counts_each_byte_once():
    """The 1920x1024 T&T grids: ~2.98 GB, 0.89 ms at 3.35 TB/s, bytes."""
    total = [ROOFLINE.fetch_bound(5, 5, 1024 * s // 4, 1920 * s // 4, (8, 16, 32), 2)
             for s in (1, 2, 4)]
    nbytes = sum(t[0] for t in total)
    assert nbytes == pytest.approx(2.983e9, rel=1e-3)
    n = 1024 * 1920
    assert total[2][0] == (5 * n * 4 * 12 + 5 * n * 4 + 4 * (n * 8 + n // 4 * 16 + n // 16 * 32) * 2
                           + n * 56 * 4 + 5 * n * 56 * 2)
    assert sum(bounds.bound_ms(*t)[0] for t in total) == pytest.approx(0.8905, abs=1e-4)
    assert {bounds.bound_ms(*t)[1] for t in total} == {"bytes"}


@pytest.mark.parametrize("rec", ["cpu", "parent"])
def test_nothing_to_read_without_the_kernel(rec):
    """No trace (the CPU), or a trace with no ``point_fetch*`` kernel (a
    program without it): both readers return None."""
    r = {"cpu": None, "parent": record([])}.get(rec)
    run = harness.Run(harness.load_cell("tt-forward"), None, r)
    assert LAUNCHES.read(run) is None and ROOFLINE.read(run) is None


@pytest.mark.parametrize("views,g,h,w,widths,dtype", [
    (5, 5, 40, 56, (8, 16, 32), torch.bfloat16), (3, 7, 37, 53, (3, 6, 12), torch.float32),
    (2, 1, 8, 8, (8,), torch.bfloat16)])
def test_the_bound_is_the_smoke_tests(views, g, h, w, widths, dtype):
    """``fetch_bound`` against ``chip_smoke.py::point_fetch_bound`` on
    arguments of the kernel's shapes (the byte count's other copy)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_for_fetch", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    n, s = h * w, views - 1
    levels = [torch.empty(1, views, h >> l, w >> l, c, dtype=dtype) for l, c in enumerate(widths)]
    args = (levels, torch.empty(1, s, g * n, 2), torch.empty(1, s, g * n),
            [torch.empty(1, n, c) for c in widths], torch.empty(1, g, n))
    esize = torch.finfo(dtype).bits // 8
    assert ROOFLINE.fetch_bound(views, g, h, w, widths, esize) == smoke.point_fetch_bound(*args)
