"""The port's benchmark (``pointmvsnet_tpu_torch/bench.py``: the headline,
``measure_train_step``, the details sections) and its roofline
(``pointmvsnet_tpu_torch/benchmarks/roofline.py``) against the JAX
package's ``bench.py`` and ``benchmarks/roofline.py``, on the CPU at a tiny
size (64×128, V=3, D=16, base widths 4, EdgeConv (8, 8), head (8, 1)):

- the headline's forward (``bench.headline``, the model and inputs that
  ``run`` times) against the JAX model's apply on the same inputs and
  weights, in f32, with tests/test_full_parity.py's bars;
- the first step's losses of ``measure_train_step`` against the JAX
  package's ``loss_fn`` on the train-mode forward of its ``make_train_step``
  (``train=True``, BN statistics mutable) at the same weights, rtol 1e-4.
  The forward loss only: the jitted JAX train step on the CPU gives wrong
  EdgeConv gradients (ROADMAP, queue 3);
- the line's keys and metric name, the details sections and their keys,
  read from ``bench.py``'s source (importing it would pull in its JAX
  paths); where the details go; the error line and the exit codes;
- the roofline's engine-independent counts equal to the JAX table's, and
  its recounted taps equal to the rows the port's ``index_select`` gathers
  in one forward.
The card's numbers come from ``chip_smoke.py`` phase ``bench``."""

import ast
import contextlib
import functools
import importlib.util
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointmvsnet_tpu_torch.models.pointmvsnet as tpointmvsnet
import pointmvsnet_tpu_torch.ops.cost_volume as tcost_volume
import pointmvsnet_tpu_torch.ops.sampling as tsampling
from pointmvsnet_tpu.config import get_default_cfg as jget_default_cfg
from pointmvsnet_tpu.models import build_model as jbuild_model
from pointmvsnet_tpu_torch import bench
from pointmvsnet_tpu_torch.benchmarks import roofline
from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.utils.convert import jax_to_torch
from test_torch_model import jax_variables, unflatten
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
V, H, W, D = 3, 64, 128, 16
BASE = 4


def tiny(cfg):
    cfg.MODEL.IMG_BASE_CHANNELS = BASE
    cfg.MODEL.VOL_BASE_CHANNELS = BASE
    cfg.MODEL.EDGE_CHANNELS = (8, 8)
    cfg.MODEL.FLOW_CHANNELS = (8, 1)
    return cfg


@pytest.fixture(autouse=True)
def no_bench_env(monkeypatch):
    for key in list(os.environ):
        if key.startswith("BENCH_"):
            monkeypatch.delenv(key)


@contextlib.contextmanager
def tiny_bench(dtype="float32", flat=None):
    """``bench`` at the tiny widths, ``build`` at ``dtype`` (None: its
    default, bf16), weights ``flat`` (JAX variables) where given."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "get_default_cfg", lambda: tiny(get_default_cfg()))
        if dtype is not None:
            mp.setattr(bench, "build", functools.partial(bench.build, dtype=dtype))
        if flat is not None:
            mp.setattr(bench, "init_params",
                       lambda model, gen: {**model.state_dict(), **jax_to_torch(flat)})
        yield mp


def jax_cfg(**model):
    cfg = tiny(jget_default_cfg())
    cfg.MODEL.NORM = "bn"
    cfg.MODEL.DTYPE = "float32"
    for k, v in model.items():
        cfg.MODEL[k] = v
    return cfg


# ------------------------------------------------------------------ bench.py's source

def jax_bench_literals():
    """From bench.py's source: the headline line's keys and metric, the
    error line's keys, the details' top-level and ``measured_at`` keys, the
    section names in order, and ``measure_train_step``'s result keys."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    out = {"sections": []}

    def keys(d):
        return [k.value for k in d.keys]

    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) for k in node.keys):
            ks = keys(node)
            if ks[:1] == ["metric"] and "baseline_source" in ks:
                out["line"] = ks
                out["metric"] = ast.literal_eval(node.values[0])
            elif ks[:1] == ["metric"] and "error" in ks and "baseline_source" not in ks:
                out["error_line"] = ks
            elif ks[:1] == ["complete"]:
                out["details"] = ks
                out["measured_at"] = keys(node.values[ks.index("measured_at")])
            elif ks[:1] == ["batch_size"]:
                out["train_step"] = ks
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "section":
            out["sections"].append(node.args[0].value)
    return out


def test_constants_equal_bench_py():
    lit = jax_bench_literals()
    assert bench.METRIC == lit["metric"]
    assert lit["metric"] == "dtu_eval_depth_maps_per_sec_per_chip_640x512_V5_D96_3flow"
    src = open(os.path.join(ROOT, "bench.py")).read()
    assert f'BASELINE_SOURCE = ("{bench.BASELINE_SOURCE[:40]}' in src
    assert bench.BASELINE_MAPS_PER_SEC == 1.0 / 3.0 and bench.UNIT == "depth_maps/sec/chip"
    assert lit["sections"] == ["stages_s", "V3_D48_fullres", "V5_D96_batch2", "roofline",
                               "train_step"]


# ------------------------------------------------------------------ (a) headline forward

@pytest.fixture(scope="module")
def headline_forwards():
    """The headline's model and inputs (bench.headline) at the tiny size in
    f32 on the CPU, and the JAX model (bench.build's config, the default
    FLOW_CHUNK_ROWS) jitted on the same inputs and weights (kernels ×2,
    as tests/test_torch_model.py draws them)."""
    jm, _, _ = jbuild_model(jax_cfg())
    im, cm = (t.numpy() for t in bench.make_inputs(1, V, H, W, D, device="cpu"))
    flat = jax_variables(jm, np.random.RandomState(3), jnp.asarray(im[:, :, :64, :64]),
                         jnp.asarray(cm), is_flow=True, img_scales=(0.25,),
                         inter_scales=(0.75,), num_virtual_plane=8, kernel_scale=2.0)
    with tiny_bench(flat=flat):
        cfg, model, images, cams, kwargs = bench.headline("cpu", 1, V, H, W, D)
        with torch.inference_mode():
            got = {k: v.numpy() for k, v in model(images, cams, **kwargs).items()}
    fn = jax.jit(lambda v, a, b: jm.apply(v, a, b, **kwargs))
    want = {k: np.asarray(v) for k, v in fn(unflatten(flat), jnp.asarray(im),
                                            jnp.asarray(cm)).items()}
    return cfg, model, kwargs, want, got


def test_headline_config(headline_forwards):
    """bench.py's headline: TEST scales, D, BN eval, the default band
    height, B=1 inputs from make_inputs."""
    cfg, model, kwargs, _, _ = headline_forwards
    jcfg = jget_default_cfg()
    assert kwargs == dict(is_flow=True, img_scales=tuple(jcfg.MODEL.TEST.IMG_SCALES),
                          inter_scales=tuple(jcfg.MODEL.TEST.INTER_SCALES),
                          num_virtual_plane=D)
    assert kwargs["img_scales"] == (0.25, 0.5, 1.0)
    assert cfg.MODEL.NORM == "bn" and cfg.MODEL.FLOW_CHUNK_ROWS == -1 and not model.training


def test_headline_forward_matches_jax(headline_forwards):
    """tests/test_full_parity.py's bars: max |Δdepth| < 0.05, mean < 0.005
    on every stage; confidence max < 0.02; every flow moves the depth."""
    _, _, _, want, got = headline_forwards
    assert sorted(got) == sorted(want)
    for key in ["coarse_depth_map", "flow1", "flow2", "flow3"]:
        diff = np.abs(got[key] - want[key])
        assert diff.max() < 0.05, f"{key}: max|Δdepth| = {diff.max():.4f}"
        assert diff.mean() < 0.005, f"{key}: mean|Δdepth| = {diff.mean():.4f}"
    assert got["flow3"].shape == (1, H, W)
    assert np.abs(got["coarse_prob_map"] - want["coarse_prob_map"]).max() < 0.02
    for it in (1, 2, 3):
        assert np.abs(got[f"flow{it}"] - got[f"flow{it}_input"]).max() > 1e-3


# ------------------------------------------------------------------ (b) train step

@pytest.fixture(scope="module")
def train_losses():
    """The first step's losses of measure_train_step (f32, tiny widths,
    JAX weights) and the JAX loss_fn on make_train_step's train-mode
    forward (bench.py's config: BN, unbanded, REMAT) at those weights, on
    the same batch; the kNN of the port's first step gets the JAX
    forward's kNN input points (given the same points the kNNs agree bit
    for bit, tests/test_torch_knn.py), so that f32 rounding cannot flip a
    near-tied neighbour."""
    import pointmvsnet_tpu.models.pointmvsnet as jpointmvsnet

    jcfg = jax_cfg(FLOW_CHUNK_ROWS=0, REMAT=True)
    jm, jloss, _ = jbuild_model(jcfg)
    images, cams, gt = (t.numpy() for t in bench.make_inputs(1, 3, H, W, D, with_gt=True,
                                                             device="cpu"))
    kw = dict(is_flow=True, img_scales=tuple(jcfg.MODEL.TRAIN.IMG_SCALES),
              inter_scales=tuple(jcfg.MODEL.TRAIN.INTER_SCALES), num_virtual_plane=D)
    flat = jax_variables(jm, np.random.RandomState(6), jnp.asarray(images[:, :, :64, :64]),
                         jnp.asarray(cams), is_flow=True, img_scales=(0.25,),
                         inter_scales=(0.75,), num_virtual_plane=8, kernel_scale=1.5)
    knn_points = []
    jknn = jpointmvsnet.window_knn_auto

    def recording_knn(points, *args, **kwargs):
        jax.debug.callback(lambda p: knn_points.append(np.array(p)), points, ordered=True)
        return jknn(points, *args, **kwargs)

    def forward_loss(var, im, cm, g):
        preds, _ = jm.apply(var, im, cm, train=True, mutable=["batch_stats"], **kw)
        return jloss(preds, g, cm)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpointmvsnet, "window_knn_auto", recording_knn)
        want = jax.jit(forward_loss)(unflatten(flat), jnp.asarray(images), jnp.asarray(cams),
                                     jnp.asarray(gt))
        want = {k: float(v) for k, v in want.items()}
        jax.effects_barrier()
    assert len(knn_points) == 2

    seen = []
    make_step = bench.make_train_step
    tknn = tpointmvsnet.window_knn_idx

    def recording_step(loss_fn, kwargs):
        step = make_step(loss_fn, kwargs)

        def call(state, batch):
            state, losses = step(state, batch)
            seen.append({k: float(v) for k, v in losses.items()})
            return state, losses
        return call

    def fed_knn(points, *args):
        return tknn(torch.from_numpy(knn_points.pop(0)) if knn_points else points, *args)

    with tiny_bench(flat=flat) as mp:
        mp.setattr(bench, "make_train_step", recording_step)
        mp.setattr(tpointmvsnet, "window_knn_idx", fed_knn)
        res = bench.measure_train_step(iters=1, v=3, h=H, w=W, d=D, device="cpu")
    return want, seen, res


def test_train_step_first_loss_matches_jax(train_losses):
    want, seen, _ = train_losses
    assert len(seen) == 2                       # the warm-up step, then iters=1
    first = seen[0]
    for k, v in want.items():
        assert math.isfinite(first[k]), k
        np.testing.assert_allclose(first[k], v, rtol=1e-4, err_msg=k)
    assert want["flow1_loss"] > 0 and want["flow2_loss"] > 0
    assert first["skipped_steps"] == 0


def test_train_step_result_keys(train_losses):
    _, _, res = train_losses
    assert list(res) == jax_bench_literals()["train_step"]
    assert res["batch_size"] == 1
    assert res["steps_per_sec"] == pytest.approx(1 / res["step_latency_s"])
    assert res["samples_per_sec"] == pytest.approx(1 / res["step_latency_s"])


# ------------------------------------------------------------------ (c) line and details

def quick_profilers(mp):
    """The details' stage profilers at one timed call each."""
    mp.setattr(bench, "stage_latencies", functools.partial(bench.stage_latencies, iters=1))
    mp.setattr(bench, "train_stage_latencies",
               functools.partial(bench.train_stage_latencies, iters=1))


TINY_RUN = dict(b=1, v=3, h=64, w=64, d=8, train_d=8, iters=1, batch2_iters=1, train_iters=1)


def test_line_and_details(tmp_path, monkeypatch, capsys):
    """A whole run (bf16, as the headline) with BENCH_DETAILS set, from a
    working directory that holds a BENCH_DETAILS.json: one line with
    bench.py's keys, every section of bench.py under its name plus
    ``device``, ``complete`` true, no error; the details land under
    outputs/bench_torch/ and the JAX record's bytes stay as they were."""
    monkeypatch.chdir(tmp_path)
    record = b'{"complete": true, "note": "the JAX package\'s record"}\n'
    (tmp_path / "BENCH_DETAILS.json").write_bytes(record)
    monkeypatch.setenv("BENCH_DETAILS", "1")
    lit = jax_bench_literals()
    with tiny_bench(dtype=None) as mp:
        quick_profilers(mp)
        line = bench.run("cpu", **TINY_RUN)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert list(line) == lit["line"] and line["metric"] == lit["metric"]
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] * 3, abs=2e-3)
    assert (tmp_path / "BENCH_DETAILS.json").read_bytes() == record
    path = tmp_path / bench.DEFAULT_DETAILS
    assert sorted(os.listdir(path.parent)) == ["BENCH_DETAILS.json"]
    rec = json.loads(path.read_text())
    assert list(rec) == lit["details"] + ["device"] + lit["sections"]
    assert list(rec["measured_at"]) == lit["measured_at"]
    assert rec["measured_at"]["DTYPE"] == "bfloat16" and rec["measured_at"]["NORM"] == "bn"
    assert rec["complete"] is True and rec["device"] == "cpu"
    assert "error" not in json.dumps(rec)
    assert set(rec["stages_s"]) == {"coarse_s", "flow1_iter_s", "flow2_iter_s",
                                    "flow3_iter_s", "total_s"}
    assert set(rec["V3_D48_fullres"]) == {"maps_per_sec", "latency_s"}
    assert set(rec["V5_D96_batch2"]) == {"maps_per_sec", "latency_s_per_batch"}
    assert rec["roofline"] == roofline.roofline_table(
        h=64, w=64, v=3, d=8, base_c=BASE, edge_channels=(8, 8), flow_channels=(8, 1))
    assert list(rec["train_step"]) == lit["train_step"] + ["stages_s"]
    assert {"fwd_s", "bwd_s", "step_s", "opt_s"} <= set(rec["train_step"]["stages_s"])


def test_error_line_and_exit_code_without_a_card(monkeypatch, capsys):
    """--device cuda (the default) on a box without one: bench.py's error
    line, and a non-zero exit, not bench.py's 0."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert list(line) == jax_bench_literals()["error_line"]
    assert line["metric"] == bench.METRIC and line["value"] == 0.0
    assert line["vs_baseline"] == 0.0 and "CUDA" in line["error"]


def test_failed_section_is_recorded_and_exits_nonzero(tmp_path, capsys):
    """A section that raises: its error in the file under its name, the
    other sections run, ``complete`` false, one line on stdout (the
    headline, no error line), exit code 1; --details names the file."""
    path = tmp_path / "d" / "details.json"

    def oom(**kwargs):
        raise RuntimeError("out of card memory")

    with tiny_bench() as mp:
        mp.setattr(bench, "measure", lambda model, im, cm, kw, iters=15: (2.0, 0.5))
        mp.setattr(bench, "stage_latencies", lambda *a, **k: {"total_s": 0.5})
        mp.setattr(bench, "measure_train_step", oom)
        mp.setattr(bench, "make_inputs", lambda b, v, h, w, d, device: (None, None))
        mp.setattr(bench, "run", functools.partial(bench.run, **TINY_RUN))
        assert bench.main(["--device", "cpu", "--details", str(path)]) == 1
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and json.loads(out[0])["value"] == 2.0
    rec = json.loads(path.read_text())
    assert rec["complete"] is False
    assert rec["train_step"] == {"error": "RuntimeError: out of card memory"}
    assert rec["V5_D96_batch2"] == {"maps_per_sec": 2.0, "latency_s_per_batch": 0.5}
    assert "roofline" in rec and not os.path.exists(f"{path}.tmp")


def test_details_only_on_request(tmp_path, monkeypatch, capsys):
    """Without BENCH_DETAILS or --details no file is written."""
    monkeypatch.chdir(tmp_path)
    with tiny_bench() as mp:
        mp.setattr(bench, "measure", lambda model, im, cm, kw, iters=15: (2.0, 0.5))
        mp.setattr(bench, "make_inputs", lambda b, v, h, w, d, device: (None, None))
        assert bench.main(["--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["vs_baseline"] == 6.0
    assert os.listdir(tmp_path) == []


# ------------------------------------------------------------------ (d) roofline

def jax_roofline():
    """benchmarks/roofline.py by path (it imports no JAX)."""
    spec = importlib.util.spec_from_file_location(
        "jax_roofline", os.path.join(ROOT, "benchmarks", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SAME_COUNTS = ("volume_unet", "flow_pyramid(all iters)", "flow3_knn", "flow3_edgeconv",
               "flow3_head_mlp")
RECOUNTED = ("coarse_sweep_warp", "flow3_fetch", "ref_resample")


@pytest.mark.parametrize("shape", [
    {},
    dict(h=1024, w=1280, v=3, d=48, g=7, base_c=4, edge_channels=(16, 16, 32),
         flow_channels=(32, 16, 1), knn_window=3, k=8)], ids=["default", "other"])
def test_roofline_counts_equal_the_jax_table(shape):
    want = {r["stage"]: r for r in jax_roofline().roofline_table(**shape)}
    rows = roofline.roofline_table(**shape)
    assert [r["stage"] for r in rows] == list(want)
    assert set(want) == set(SAME_COUNTS) | set(RECOUNTED)
    for r in rows:
        assert list(r) == list(want[r["stage"]])
        assert r["measured_ms"] is None and r["bound_by"] in ("compute", "bandwidth")
        if r["stage"] in SAME_COUNTS:
            for key in ("gflops", "stream_mb", "gather_rows_m"):
                assert r[key] == want[r["stage"]][key], (r["stage"], key)
        assert r["ceiling_ms"] >= round(r["stream_mb"] * 1e6 / 3.35e12 * 1e3, 4) - 1e-4
        assert "csrc/" in r["note"] or ".py" in r["note"]
    assert roofline.roofline_table(measured_ms={"flow3_fetch": 1.5})[3]["measured_ms"] == 1.5


def test_roofline_peaks_are_the_cards():
    assert (roofline.PEAK_BF16_TFLOPS, roofline.PEAK_F32_TFLOPS,
            roofline.PEAK_HBM_GBS) == (989e12, 67e12, 3.35e12)
    fetch = roofline.roofline_table()[3]
    assert fetch["stage"] == "flow3_fetch" and fetch["bound_by"] == "bandwidth"
    # 4 taps of 32 + 32 + 64 bytes per (source view, point) and the f32 moments
    assert fetch["stream_mb"] == round((4 * 5 * 512 * 640 * 4 * 128
                                        + 2 * 5 * 512 * 640 * 56 * 4) / 1e6, 1)


def test_roofline_taps_equal_the_rows_the_port_gathers(monkeypatch):
    """One bf16 forward at the tiny size: the rows ``index_select`` gathers
    inside the plane sweep's plain version and inside each flow iteration's
    fetch (``point_fetch_plain``, its per-level samples), the width and type of the rows gathered, and the
    operations of the reference view's resample in flow3, against
    ``gather_taps`` / ``ref_resample_flops`` and the table's row widths."""
    stage = [None]
    rows, widths, rgs = {}, {}, []
    flow_iter = [0]
    real_select = torch.Tensor.index_select

    def index_select(self, dim, index):
        if stage[0] is not None:
            rows[stage[0]] = rows.get(stage[0], 0) + index.numel()
            widths.setdefault(stage[0], set()).add((self.shape[-1], self.dtype))
        return real_select(self, dim, index)

    def in_stage(name_fn, fn):
        def call(*args, **kwargs):
            stage[0] = name_fn()
            try:
                return fn(*args, **kwargs)
            finally:
                stage[0] = None
        return call

    def fetch_plain(*args, **kwargs):
        flow_iter[0] += 1
        return plain(*args, **kwargs)

    def regular_grid_sample(feat, sx, sy, out_h, out_w, y_offset=0):
        b, h, w, c = feat.shape
        rgs.append((flow_iter[0] + 1, 2 * b * c * out_w * h * (w + out_h)))
        return real_rgs(feat, sx, sy, out_h, out_w, y_offset)

    plain = in_stage(lambda: f"flow{flow_iter[0]}", tsampling.point_fetch_plain)
    real_rgs = tpointmvsnet.regular_grid_sample
    monkeypatch.setattr(torch.Tensor, "index_select", index_select)
    monkeypatch.setattr(tcost_volume, "plane_sweep_plain",
                        in_stage(lambda: "coarse", tcost_volume.plane_sweep_plain))
    monkeypatch.setattr(tsampling, "point_fetch_plain", fetch_plain)
    monkeypatch.setattr(tpointmvsnet, "regular_grid_sample", regular_grid_sample)
    with tiny_bench(dtype=None):
        cfg, model, images, cams, kwargs = bench.headline("cpu", 1, V, H, W, D)
        with torch.inference_mode():
            model(images, cams, **kwargs)
    g = 2 * cfg.MODEL.FLOW_INTERVAL_M + 1
    taps = roofline.gather_taps(H, W, V, D, g)
    assert rows["coarse"] == taps["coarse_sweep_warp"]
    assert rows["flow3"] == taps["flow3_fetch"]
    assert sorted(rows) == ["coarse", "flow1", "flow2", "flow3"]     # nothing else gathers
    assert taps["ref_resample"] == 0
    assert sum(f for it, f in rgs if it == 3) == roofline.ref_resample_flops(H, W, BASE)
    bf16 = torch.bfloat16
    assert bf16.itemsize == roofline.FEAT_BYTES
    assert widths["coarse"] == {(4 * BASE, bf16)}
    assert widths["flow3"] == {(BASE, bf16), (2 * BASE, bf16), (4 * BASE, bf16)}
