"""The plane sweep kernel's readers (``metrics/sweep_launches.py``,
``metrics/sweep_device_ms.py``) on hand-built records: launches per map
where ``plane_sweep*`` kernels ran, and the device time under the
``model.sweep`` span; nothing where neither is there (the parent's
program). The fetch's launch reader and the sweep's do not count each
other's kernels. Then the probe of a tiny serve cell on the CPU, which
has the span on the host and nothing on a device."""

import json

import pytest
import torch

from perfbench import harness, spans
from perfbench.trace import WINDOW, Record

LAUNCHES = {cell: harness.load_metric(f"sweep_launches.{cell}")
            for cell in ("serve", "forward", "cascade")}
FETCH_LAUNCHES = harness.load_metric("point_fetch_launches.forward")
DEVICE_MS = {cell: harness.load_metric(f"sweep_device_ms.{cell}") for cell in ("serve", "forward")}
SWEEP = "void (anonymous namespace)::plane_sweep_kernel<__nv_bfloat16, 8>(Params)"
FETCH = "void (anonymous namespace)::point_fetch_kernel<__nv_bfloat16, 8>(Params)"


def record(sweeps_a_map, fetches_a_map=0, maps=2):
    ops = [("kernel", "void at::native::vectorized_gather_kernel<16, long>", 0.0, 500.0)]
    for m in range(maps):
        ops += [("kernel", SWEEP, 1000.0 * m + i, 50.0) for i in range(sweeps_a_map)]
        ops += [("kernel", FETCH, 1000.0 * m + 100 + i, 50.0) for i in range(fetches_a_map)]
    return Record(window_s=1.0, items=maps, ops=ops, gaps=[], busy_s=0.5)


@pytest.mark.parametrize("cell,reader,sweeps", [("dtu-serve", "serve", 1),
                                                ("tt-forward", "forward", 1),
                                                ("cas-dtu-forward", "cascade", 3)])
def test_the_launches_per_map(cell, reader, sweeps):
    run = harness.Run(harness.load_cell(cell), None, record(sweeps, fetches_a_map=3))
    assert LAUNCHES[reader].read(run) == float(sweeps)
    assert FETCH_LAUNCHES.read(run) == 3.0


@pytest.mark.parametrize("rec", ["cpu", "parent", "fetch only"])
def test_no_launches_without_the_kernel(rec):
    """No trace (the CPU), or a trace without a ``plane_sweep*`` kernel (a
    program without it, with the fetch kernel or not): None."""
    r = {"cpu": None, "parent": record(0), "fetch only": record(0, fetches_a_map=3)}[rec]
    for reader in LAUNCHES.values():
        assert reader.read(harness.Run(harness.load_cell("tt-forward"), None, r)) is None


def ev(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}
    if args:
        e["args"] = args
    return e


def kernel(name, ts, dur, corr, launch_ts):
    return [ev("kernel", name, ts, dur, correlation=corr),
            ev("cuda_runtime", "cudaLaunchKernel", launch_ts, 5, correlation=corr)]


def coarse_trace(tmp_path, with_span: bool):
    """Two maps of 100 ms (µs below): per map the coarse stage's 20 ms of
    device time, 6 of them under ``model.sweep`` (the projection 2 ms, the
    kernel 4 ms), and flow3's 30 ms."""
    events = [ev("user_annotation", WINDOW, 0, 200_000)]
    corr = 0
    for m in range(2):
        t = 100_000 * m
        events += [ev("user_annotation", "perfbench.map", t, 100_000),
                   ev("user_annotation", "pmvs.model.coarse", t, 40_000),
                   ev("user_annotation", "pmvs.model.flow3", t + 40_000, 50_000)]
        if with_span:
            events.append(ev("user_annotation", "pmvs.model.sweep", t + 10_000, 10_000))
        for name, start, dur, launch in [("conv", 1_000, 14_000, 1_000),
                                         ("einsum", 15_000, 2_000, 11_000),
                                         (SWEEP, 17_000, 4_000, 12_000),
                                         ("edge", 45_000, 30_000, 41_000)]:
            corr += 1
            events += kernel(name, t + start, dur, corr, t + launch)
    path = tmp_path / f"trace_{with_span}.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return spans.read_spans(str(path), 2)


@pytest.mark.parametrize("reader", ["serve", "forward"])
def test_the_device_ms_under_the_span(tmp_path, reader):
    rec = coarse_trace(tmp_path, True)
    run = harness.Run(cell=None, driver=None, record=None, memo={"spans": rec})
    assert DEVICE_MS[reader].read(run) == pytest.approx(6.0)
    assert spans.device_ms_per_item(run, "model.coarse") == pytest.approx(20.0)
    parent = harness.Run(cell=None, driver=None, record=None,
                         memo={"spans": coarse_trace(tmp_path, False)})
    assert DEVICE_MS[reader].read(parent) is None


def test_the_probe_on_the_cpu_has_the_span():
    """The tiny serve cell's program opens ``model.sweep`` once a request,
    inside ``model.coarse``; no device, so the reader reads nothing."""
    from tiny import tiny_cell
    cell = tiny_cell("dtu-serve")
    driver = harness.load_driver("serve").Driver(cell, 2 ** 31 + 11, torch.device("cpu"))
    rec = spans.profile_items(spans.driver_item(driver, "serve"), 2, "request",
                              torch.device("cpu"))
    assert len(rec.host["model.sweep"]) == len(rec.host["model.coarse"]) == 2
    assert max(rec.host["model.sweep"]) <= max(rec.host["model.coarse"])
    run = harness.Run(cell=cell, driver=driver, record=None, memo={"spans": rec})
    assert DEVICE_MS["serve"].read(run) is None
