"""The cell ``cas-dtu-forward`` (CasMVSNet), found by name and run tiny on
the CPU; the readers of the cascade's spans, its sweep's roofline and its
``mfu`` on hand-built traces; the sweep's byte count against a hand
count."""

import json
import sys

import pytest
import torch

from perfbench import harness, spans
from perfbench.counts import bounds
from perfbench.counts.flops import peak_seconds
from perfbench.trace import WINDOW, Record

ROOFLINE = harness.load_metric("cascade_sweep_roofline.cascade")
MFU_CASCADE = harness.load_metric("mfu.cascade")


def ev(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}
    if args:
        e["args"] = args
    return e


def kernel(name, ts, dur, corr, launch_ts):
    return [ev("kernel", name, ts, dur, correlation=corr),
            ev("cuda_runtime", "cudaLaunchKernel", launch_ts, 5, correlation=corr)]


def cascade_trace(path):
    """Two maps of 100 ms (µs below): per map features 10 ms of device time,
    stage 3's sweep 30 ms and its U-Net 20 ms, stage 1's sweep 5 ms; 1 ms of
    a kernel launched outside every span."""
    events = [ev("user_annotation", WINDOW, 0, 200_000)]
    corr = 0
    for m in range(2):
        t = 100_000 * m
        events += [ev("user_annotation", "perfbench.map", t, 100_000),
                   ev("user_annotation", "pmvs.cascade.features", t, 10_000),
                   ev("user_annotation", "pmvs.cascade.stage1", t + 10_000, 10_000),
                   ev("user_annotation", "pmvs.cascade.sweep", t + 10_000, 5_000),
                   ev("user_annotation", "pmvs.cascade.stage3", t + 40_000, 55_000),
                   ev("user_annotation", "pmvs.cascade.sweep", t + 40_000, 30_000),
                   ev("user_annotation", "pmvs.cascade.regularize", t + 70_000, 25_000)]
        for name, start, dur, launch in (("conv", 1_000, 10_000, 500), ("gather", 12_000, 5_000,
                                                                        10_500),
                                         ("gather", 41_000, 30_000, 40_500),
                                         ("conv3d", 72_000, 20_000, 70_500)):
            corr += 1
            events += kernel(name, t + start, dur, corr, t + launch)
    corr += 1
    events += kernel("stray", 195_000, 1_000, corr, 199_500)
    path.write_text(json.dumps({"traceEvents": events}))
    return spans.read_spans(str(path), 2)


def test_the_cascade_span_readers(tmp_path):
    run = harness.Run(harness.load_cell("cas-dtu-forward"), None, None)
    run.memo["spans"] = cascade_trace(tmp_path / "trace.json")
    want = {"cascade_features_device_ms.cascade": 10.0, "cascade_sweep_device_ms.cascade": 35.0,
            "cascade_regularize_device_ms.cascade": 20.0, "stage_device_ms.stage3.cascade": 50.0}
    for name, ms in want.items():
        assert harness.load_metric(name).read(run) == pytest.approx(ms), name
    least = ROOFLINE.least_ms(run.cell.config)
    assert ROOFLINE.read(run) == pytest.approx(100.0 * least / 35.0)
    assert 0 < ROOFLINE.read(run) < 100
    # the program without the cascade's spans (the parent's) reads nothing
    run.memo["spans"] = None
    assert all(harness.load_metric(n).read(run) is None for n in want)
    assert ROOFLINE.read(run) is None


def test_the_sweep_byte_count_by_hand():
    """Stage 3 at 864x1152, 8 hypotheses a pixel, 8 channels, V = 5, bf16:
    the five views' features 5·864·1152·8·2 B, the per-pixel hypotheses
    8·864·1152·4 B, the volume 8·864·1152·8·2 B. Stage 1's 48 planes at
    216x288 with 32 channels: 48·4 B of hypotheses."""
    n = 864 * 1152
    nbytes, ops = ROOFLINE.sweep_bound(5, 8, 864, 1152, 8, 2, True)
    assert nbytes == 5 * n * 16 + 8 * n * 4 + 8 * n * 16 == 238_878_720
    assert ops == 8 * n * 8 * 45
    nbytes, _ = ROOFLINE.sweep_bound(5, 48, 216, 288, 32, 2, False)
    assert nbytes == 5 * 216 * 288 * 64 + 48 * 4 + 48 * 216 * 288 * 64
    cell = harness.load_cell("cas-dtu-forward")
    stages = [ROOFLINE.sweep_bound(5, 48, 216, 288, 32, 2, False),
              ROOFLINE.sweep_bound(5, 32, 432, 576, 16, 2, True),
              ROOFLINE.sweep_bound(5, 8, 864, 1152, 8, 2, True)]
    assert ROOFLINE.least_ms(cell.config) == pytest.approx(
        sum(bounds.bound_ms(*s)[0] for s in stages))


def test_the_mfu_reader():
    """Operations per map times the maps over the window less its waits."""
    rec = Record(window_s=2.0, items=4, ops=[("kernel", "k", 0.0, 10.0)], gaps=[], busy_s=1.0,
                 active_s=2.0, active_busy_s=1.0)
    cas = harness.load_cell("cas-dtu-forward")
    run = harness.Run(cas, None, rec)
    ops = MFU_CASCADE.forward_flops(cas.config)
    assert set(ops) == {"bfloat16", "float32"} and ops["bfloat16"] > 3e11
    assert MFU_CASCADE.read(run) == pytest.approx(100.0 * 4 * peak_seconds(ops) / 2.0)
    assert MFU_CASCADE.read(harness.Run(cas, None, None)) is None


def test_cas_dtu_forward_runs_tiny():
    from tiny import tiny_cell
    import time
    cell = tiny_cell("cas-dtu-forward")
    cell.config["eval"].update(height=64, width=96)
    out = harness.run_cell(cell, 2 ** 31 + 77, 0.5, False, torch.device("cpu"),
                           time.perf_counter())
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == {f"stage{s}_{m}" for s in (1, 2, 3)
                                  for m in ("depth", "confidence")} | {"stage2_step",
                                                                       "stage3_step"}
    assert set(out["metrics"]) == {"maps_per_s", "peak_mem_gib", "setup_s"}


def test_the_cascade_faults_move_the_program():
    """Each planted fault changes what the program returns."""
    from perfbench.tools import cascade_readings
    from pointmvsnet_tpu_torch.config import load_cfg_from_file
    from pointmvsnet_tpu_torch.models import build_model
    from pointmvsnet_tpu_torch.utils.convert import init_params
    sys.path.insert(0, str(harness.ROOT / "tests"))
    from test_torch_casmvsnet import CFG_FILE, _scene

    cfg = load_cfg_from_file(CFG_FILE)
    cfg.MODEL.DTYPE = "float32"
    cfg.MODEL.CASCADE.NDEPTHS = (8, 8, 8)
    model = build_model(cfg, "cpu")
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(3)))
    images, cams = _scene(2)
    with torch.no_grad():
        base = model(images, cams)
        for name, keys in (("not_recentred", ("stage2_depth", "stage3_depth")),
                           ("argmax_confidence", ("stage1_confidence",))):
            with cascade_readings.FAULTS[name]():
                out = model(images, cams)
            assert any(not torch.equal(out[k], base[k]) for k in keys), name
