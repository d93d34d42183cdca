"""The readers of the program's spans (``perfbench/spans.py``) on a
hand-built Chrome trace: host launches (``cuda_runtime``) and device
operations joined by ``correlation``, the program's ``pmvs.`` spans inside
the harness's. Each new reader's value, the share of busy time under a
program span, gap naming, and the accepted readers unmoved by the
program's spans. Then the probe's profile of a tiny serve cell on the CPU,
where the program's spans are there and the device's operations are not."""

import json

import pytest
import torch

from perfbench import harness, readers, spans
from perfbench.trace import WINDOW, read_trace


def ev(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}
    if args:
        e["args"] = args
    return e


def kernel(name, ts, dur, corr, launch_ts, tid=1):
    """A kernel on the device and its launch on the host (thread ``tid``)."""
    return [ev("kernel", name, ts, dur, correlation=corr),
            dict(ev("cuda_runtime", "cudaLaunchKernel", launch_ts, 5, correlation=corr),
                 tid=tid)]


def serve_events(program: bool):
    """One request of 100 ms (µs below) after a 10 ms wait. Device work:
    H2D 2 ms; coarse 10 ms; flow3's fetch (a gather 20 ms, launched early,
    and 5 ms more) and EdgeConv (15 ms); D2H 1 ms; a kernel launched before
    the request (4 ms, no program span). Host phases: prepare 10-40 ms,
    to_device 40-42, model 42-90, to_host 90-100."""
    out = [ev("user_annotation", WINDOW, 0, 110_000),
           ev("user_annotation", "perfbench.wait", 0, 10_000),
           ev("user_annotation", "perfbench.request", 10_000, 100_000)]
    if program:
        out += [ev("user_annotation", "pmvs.predictor.prepare", 10_000, 30_000),
                ev("user_annotation", "pmvs.predictor.to_device", 40_000, 2_000),
                ev("user_annotation", "pmvs.predictor.model", 42_000, 48_000),
                ev("user_annotation", "pmvs.model.coarse", 42_000, 8_000),
                ev("user_annotation", "pmvs.model.flow3", 50_000, 40_000),
                ev("user_annotation", "pmvs.point_flow.fetch", 50_000, 10_000),
                ev("user_annotation", "pmvs.point_flow.edge_conv", 60_000, 20_000),
                ev("user_annotation", "pmvs.predictor.to_host", 90_000, 10_000),
                # the device-side copy of a span: not a host span
                ev("gpu_user_annotation", "pmvs.model.flow3", 60_000, 40_000)]
    out += [ev("gpu_memcpy", "Memcpy HtoD", 41_000, 2_000, correlation=1),
            dict(ev("cuda_runtime", "cudaMemcpyAsync", 40_500, 10, correlation=1))]
    out += kernel("vectorized_gather_kernel", 52_000, 20_000, 2, 51_000)
    out += kernel("window_knn_kernel", 50_000, 1_000, 3, 45_000)        # coarse's
    out += kernel("elementwise", 51_000, 9_000, 4, 46_000)              # coarse's
    out += kernel("masked_window_max_kernel", 72_000, 15_000, 5, 61_000, tid=2)
    out += kernel("elementwise", 87_000, 5_000, 6, 59_000)              # the fetch's
    out += [ev("gpu_memcpy", "Memcpy DtoH", 95_000, 1_000, correlation=7),
            ev("cuda_runtime", "cudaMemcpyAsync", 94_000, 10, correlation=7)]
    out += kernel("early", 5_000, 4_000, 8, 4_000)
    return out


def write(tmp_path, events, name="trace.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


@pytest.fixture
def record(tmp_path):
    return spans.read_spans(write(tmp_path, serve_events(True)), 1)


def run_of(rec, cell=None):
    return harness.Run(cell=cell, driver=None, record=None, memo={"spans": rec})


def test_device_time_under_each_span(record):
    # unions: coarse 50-60 (two ops overlap); fetch 52-72 and 87-92; EdgeConv 72-87
    assert record.device_seconds("model.coarse") == pytest.approx(0.010)
    assert record.device_seconds("point_flow.fetch") == pytest.approx(0.025)
    assert record.device_seconds("point_flow.edge_conv") == pytest.approx(0.015)
    assert record.device_seconds("model.flow3") == pytest.approx(0.040)
    assert record.device_seconds("predictor.model") == pytest.approx(0.042)
    assert record.device_seconds("predictor.to_device") == pytest.approx(0.002)
    assert record.device_seconds("predictor.to_host") == pytest.approx(0.001)
    assert record.device_seconds("point_flow.fetch", "point_flow.edge_conv") == \
        pytest.approx(0.040)
    assert record.device_seconds("predictor.prepare") == 0.0
    assert record.unlaunched == 0


def test_share_of_busy_time_under_a_program_span(record):
    # busy: 5-9, 41-43, 50-92, 95-96 = 49 ms; the early kernel's 4 ms are outside
    assert record.busy_s == pytest.approx(0.049)
    assert record.attributed_share() == pytest.approx(45 / 49)
    assert record.by_innermost()[0] == ["point_flow.fetch", pytest.approx(0.025)]
    assert ["-", pytest.approx(0.004)] in record.by_innermost()
    assert record.top_ops(2) == [["point_flow.fetch", "vectorized_gather_kernel",
                                  pytest.approx(0.020)],
                                 ["point_flow.edge_conv", "masked_window_max_kernel",
                                  pytest.approx(0.015)]]


def test_gaps_are_named_by_the_innermost_span(record):
    # 0-5 in the wait; 9-41 in prepare; 43-50 in coarse (inside predictor.model);
    # 92-95 in to_host; 96-110 in the request after its last span
    assert sorted((round(s * 1e3), n) for n, s in record.gaps) == [
        (3, "predictor.to_host"), (5, "wait"), (7, "model.coarse"), (14, "request"),
        (32, "predictor.prepare")]
    assert record.idle_by_span()[:2] == [["predictor.prepare", pytest.approx(0.032)],
                                         ["request", pytest.approx(0.014)]]


def test_the_readers(record, tmp_path):
    run = run_of(record)
    assert spans.host_ms(run, "predictor.prepare") == pytest.approx(30.0)
    for name, want in [("predictor.prepare_ms", 30.0), ("stage_device_ms.flow3.serve", 40.0),
                       ("stage_device_ms.flow3.forward", 40.0), ("fetch_device_ms.serve", 25.0),
                       ("fetch_device_ms.forward", 25.0), ("edge_conv_device_ms.serve", 15.0),
                       ("edge_conv_device_ms.forward", 15.0)]:
        assert harness.load_metric(name).read(run) == pytest.approx(want), name
    # no train spans here, and no record at all: nothing to read
    assert harness.load_metric("train_device_ms.forward").read(run) is None
    assert harness.load_metric("stage_device_ms.flow3.serve").read(run_of(None)) is None
    two = spans.read_spans(write(tmp_path, serve_events(True), "two.json"), 2)
    assert spans.device_ms_per_item(run_of(two), "model.flow3") == pytest.approx(20.0)


def test_train_readers_take_the_autograd_threads_launches(tmp_path):
    """Forward 0-30 ms and loss 30-35 on the main thread; backward 35-80,
    its kernels launched by another thread; the optimizer 80-90 in a step
    of 90 ms in a window of 100."""
    events = [ev("user_annotation", WINDOW, 0, 100_000),
              ev("user_annotation", "perfbench.step", 0, 90_000),
              ev("user_annotation", "pmvs.train_step.forward", 0, 30_000),
              ev("user_annotation", "pmvs.model.coarse", 1_000, 10_000),
              ev("user_annotation", "pmvs.train_step.loss", 30_000, 5_000),
              ev("user_annotation", "pmvs.train_step.backward", 35_000, 45_000),
              ev("user_annotation", "pmvs.train_step.optimizer", 80_000, 10_000)]
    events += kernel("conv", 2_000, 20_000, 1, 1_500)
    events += kernel("loss", 31_000, 3_000, 2, 30_500)
    events += kernel("conv_bwd", 40_000, 30_000, 3, 36_000, tid=7)
    events += kernel("gather_bwd", 70_000, 8_000, 4, 37_000, tid=7)
    events += kernel("rmsprop", 83_000, 5_000, 5, 81_000)
    rec = spans.read_spans(write(tmp_path, events), 1)
    run = run_of(rec)
    assert harness.load_metric("train_device_ms.forward").read(run) == pytest.approx(23.0)
    assert harness.load_metric("train_device_ms.backward").read(run) == pytest.approx(38.0)
    assert rec.attributed_share() == pytest.approx(1.0)
    assert sorted((round(s * 1e3), n) for n, s in rec.gaps) == [
        (2, "model.coarse"), (5, "train_step.optimizer"), (6, "train_step.backward"),
        (9, "train_step.forward"), (12, "window")]


def test_a_kernel_without_its_launch_is_under_no_span(tmp_path):
    events = [e for e in serve_events(True)
              if not (e["cat"] == "cuda_runtime" and e["args"]["correlation"] == 2)]
    rec = spans.read_spans(write(tmp_path, events), 1)
    assert rec.unlaunched == 1
    assert rec.device_seconds("point_flow.fetch") == pytest.approx(0.005)


def test_the_accepted_readers_are_unmoved_by_the_program_spans(tmp_path):
    cell = harness.load_cell("dtu-serve")
    recs = [read_trace(write(tmp_path, serve_events(p), f"{p}.json"), 1) for p in (False, True)]
    values = []
    for rec in recs:
        rec.host = {"request_s": [0.1], "model_call_s": [0.05]}
        run = harness.Run(cell=cell, driver=None, record=rec,
                          memo={"mask_bits": {g: 1000.0 for g in
                                              [(5, 128, 160), (5, 256, 320), (5, 512, 640)]}})
        values.append([readers.idle_pct(run), readers.launches_per_item(run),
                       readers.host_ms(run), readers.knn_roofline(run),
                       readers.mwm_roofline(run), readers.mfu(run),
                       rec.busy_s, rec.active_s, rec.active_busy_s, rec.ops, rec.gaps,
                       rec.top_ops(), rec.top_gaps()])
    assert all(v is not None for v in values[0])
    assert values[0] == values[1]


def test_the_probe_on_the_cpu():
    """The tiny serve cell's driver, profiled as the probe profiles it: the
    program's host spans are there, the device's operations are not, so
    every device reader reads nothing; with no card the probe does not run."""
    from tiny import tiny_cell
    cell = tiny_cell("dtu-serve")
    driver = harness.load_driver("serve").Driver(cell, 2 ** 31 + 7, torch.device("cpu"))
    rec = spans.profile_items(spans.driver_item(driver, "serve"), 2, "request",
                              torch.device("cpu"))
    assert rec.ops == [] and rec.busy_s == 0.0
    assert len(rec.host["predictor.prepare"]) == 2
    assert len(rec.host["model.flow3"]) == 2 and len(rec.host["point_flow.fetch"]) == 6
    run = harness.Run(cell=cell, driver=driver, record=None, memo={"spans": rec})
    assert harness.load_metric("predictor.prepare_ms").read(run) > 0
    assert harness.load_metric("fetch_device_ms.serve").read(run) is None
    assert len(rec.gaps) == 1                # the whole window: nothing on a device
    assert spans.probe(harness.Run(cell=cell, driver=driver, record=None)) is None
