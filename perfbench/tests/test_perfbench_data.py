"""The harness is driven by data: every cell, configuration, traffic mix,
limit and per-layer metric named in BENCHMARK.json is a file found by its
name, and a cell added as data alone runs with no edit to the harness."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_is_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.limits, f"perfbench/limits/{cell}.json"
    assert (harness.HERE / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2 and c.per_layer
    for name in c.per_layer:
        assert hasattr(harness.load_metric(name), "read")


def test_config_files_match_the_benchmark():
    for conf in BENCH["configs"]:
        data = json.loads((ROOT / conf["file"]).read_text())
        assert data["source"] == conf["source"] and data["reduced"] == conf["reduced"]


def test_a_cell_added_as_data_runs(tmp_path):
    base = tmp_path / "perfbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(harness.HERE / sub, base / sub)
    traffic = json.loads((base / "traffic" / "frames_at_fixed_rate.json").read_text())
    traffic.update(pool=1, rate_per_s=8.0, warmup=1)
    (base / "traffic" / "one_scene.json").write_text(json.dumps(traffic))
    config = json.loads((base / "configs" / "dtu_wde3.json").read_text())
    config["eval"].update(height=64, width=128, num_depth=16)
    (base / "configs" / "dtu_small.json").write_text(json.dumps(config))
    shutil.copy(base / "limits" / "dtu-serve.json", base / "limits" / "extra-serve.json")
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "extra-serve", "config": "dtu_small", "traffic": "one_scene", "chips": 1,
         "why": "a throwaway cell"}])
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "dtu-serve" in m.get("workloads", ()):
            m["workloads"] = m["workloads"] + ["extra-serve"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("extra-serve", tmp_path / "BENCHMARK.json", base)
    assert cell.traffic["pool"] == 1 and cell.config["eval"]["height"] == 64
    out = harness.run_cell(cell, 5, 0.5, False, torch.device("cpu"), 0.0)
    assert set(out["metrics"]) == {"request_ms_p90", "request_ms_p50", "peak_mem_gib",
                                   "setup_s"}
    assert out["attempted"] == 4 and out["failed"] == 0 and out["checks"]


def test_traced_run_reads_its_metrics():
    from tiny import run_tiny
    out = run_tiny("dtu-serve", trace=True, seconds=0.5)
    # the CPU has no device trace: only the host's readers have something to read
    assert set(out["metrics"]) == {"predictor.host_ms", "stage_ms.flow3.serve"}
    assert out["metrics"]["predictor.host_ms"]["value"] > 0
    assert list(out)[-1] == "checks"


def test_the_trace_reader_leaves_out_an_open_loops_waits(tmp_path):
    """A window of 10 ms: a wait of 4 ms, then a request with 3 ms of
    device work. Idle is read over the 6 ms outside the wait."""
    from perfbench import readers
    from perfbench.trace import WINDOW, read_trace

    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = [ev("user_annotation", WINDOW, 0, 10_000),
              ev("user_annotation", "perfbench.wait", 0, 4_000),
              ev("user_annotation", "perfbench.request", 4_000, 6_000),
              ev("kernel", "k", 5_000, 2_000), ev("kernel", "k", 6_500, 1_500)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    rec = read_trace(str(path), 1)
    assert rec.window_s == pytest.approx(0.010) and rec.busy_s == pytest.approx(0.003)
    assert rec.active_s == pytest.approx(0.006) and rec.active_busy_s == pytest.approx(0.003)
    run = harness.Run(cell=None, driver=None, record=rec)
    assert readers.idle_pct(run) == pytest.approx(50.0)
    assert rec.top_gaps() == [["wait", pytest.approx(0.005)], ["request", pytest.approx(0.002)]]


@pytest.mark.parametrize("name,file", [("mfu.serve", "mfu.py"), ("mfu.train", "mfu.py"),
                                       ("train_ms.forward", "train_ms.forward.py"),
                                       ("stage_ms.flow3.forward", "stage_ms.flow3.py")])
def test_a_split_metric_name_finds_its_reader(name, file):
    mod = harness.load_metric(name)
    assert mod.__file__ == str(harness.HERE / "metrics" / file)
