"""The port's T&T sweep (``pointmvsnet_tpu_torch/benchmarks/tt_sweep.py``)
and the ``bench.py`` helpers it imports (``pointmvsnet_tpu_torch/bench.py``)
against the JAX package's ``benchmarks/tt_sweep.py`` and ``bench.py``:
inputs, config, the sweep's forward (depth within the bars of
tests/test_full_parity.py), the token grammar and defaults, resume, what
is recorded as an error, and ``measure``'s windows. The port runs on the
CPU; the card's numbers come from ``chip_smoke.py`` phase ``tanks``."""

import ast
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from pointmvsnet_tpu_torch import bench
from pointmvsnet_tpu_torch.benchmarks import tt_sweep
from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
from pointmvsnet_tpu_torch.utils.convert import load_jax_variables
from test_torch_model import KERNEL_SCALE, jax_variables, unflatten
from torch_threads import one_torch_thread  # noqa: F401

JAX_SWEEP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "benchmarks",
                         "tt_sweep.py")
H, W, V, D = 64, 128, 3, 16
BAND = 32           # two bands of the 64-row flow3 map (64 > 32 + 2·8); flow1-2 stay whole


@pytest.fixture(autouse=True)
def no_bench_env(monkeypatch):
    """The JAX build reads BENCH_* A/B variables; the port has none."""
    for key in list(os.environ):
        if key.startswith("BENCH_"):
            monkeypatch.delenv(key)


def jax_sweep_literals():
    """The JAX tool's default tokens, its forward kwargs and its ``iters``,
    read from its source (its ``main`` holds them as literals)."""
    tree = ast.parse(open(JAX_SWEEP).read())
    tokens = kwargs = iters = None
    for node in ast.walk(tree):
        if isinstance(node, ast.List) and node.elts and all(
                isinstance(e, ast.Constant) and "@" in str(e.value) for e in node.elts):
            tokens = [e.value for e in node.elts]
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "dict" and any(
                k.arg == "is_flow" for k in node.keywords):
            kwargs = {k.arg: ast.literal_eval(k.value) for k in node.keywords}
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "measure":
            iters = next(ast.literal_eval(k.value) for k in node.keywords if k.arg == "iters")
    return tokens, kwargs, iters


# ------------------------------------------------------------------ bench.py helpers

def test_make_inputs_against_jax_bench():
    """Cams and GT bit-equal to bench.py's; images the port's
    make_scene_batch bit for bit (the port renders the same scene in numpy,
    the JAX package with cv2, so their pixels differ by design), with the
    JAX images' shape and dtype."""
    want = [np.asarray(a) for a in jbench.make_inputs(2, V, H, W, D, with_gt=True)]
    got = [t.numpy() for t in bench.make_inputs(2, V, H, W, D, with_gt=True, device="cpu")]
    assert [(a.shape, a.dtype) for a in got] == [(a.shape, a.dtype) for a in want]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    np.testing.assert_array_equal(got[0].view(np.uint32),
                                  make_scene_batch(2, V, H, W, D)[0].view(np.uint32))
    assert len(bench.make_inputs(1, 2, 64, 64, 8, device="cpu")) == 2


PORT_ONLY_KEYS = ["MODEL.CASCADE.DEPTH_INTERVAL_RATIOS", "MODEL.CASCADE.NDEPTHS"]


def flat_cfg(node, prefix=""):
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out.update(flat_cfg(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("token", tt_sweep.DEFAULT_TOKENS + ["bilinear:0@1920x1024"])
def test_build_config_equals_jax_bench(token):
    """For each token's (engine, chunk_rows), key for key, value and type;
    the port's config has the JAX package's keys and, besides them, only
    its own CasMVSNet section (``MODEL.CASCADE``), which the JAX package
    has no model for."""
    engine, chunk, _, _ = tt_sweep.parse_token(token)
    cfg, model = bench.build(fetch=engine, chunk_rows=chunk, device="cpu")
    jcfg, _ = jbench.build(fetch=engine, chunk_rows=chunk)
    got, want = flat_cfg(cfg), flat_cfg(jcfg)
    assert sorted(set(got) - set(want)) == PORT_ONLY_KEYS
    assert set(want) <= set(got)
    for k, v in want.items():
        assert got[k] == v and type(got[k]) is type(v), k
    assert cfg.MODEL.FLOW_CHUNK_ROWS == chunk and cfg.MODEL.DTYPE == "bfloat16"
    assert not model.training and model.dtype == torch.bfloat16


def test_build_rejects_a_tpu_fetch_engine():
    with pytest.raises(ValueError, match="FLOW_FETCH"):
        bench.build(fetch="table", device="cpu")


@pytest.fixture(scope="module")
def sweep_forwards():
    """The sweep's forward (tt_sweep.build, KWARGS at D=16) in f32 on the
    CPU and the JAX bench.build model's apply (jitted), unbanded and at
    BAND rows, on the same scene and the same variables (kernels ×2, as
    tests/test_torch_model.py draws them)."""
    images, cams, _ = make_scene_batch(1, V, H, W, D, seed=4)
    kw = dict(tt_sweep.KWARGS, num_virtual_plane=D)
    flat = None
    out = {}
    for chunk in (0, BAND):
        _, jm = jbench.build(dtype="float32", chunk_rows=chunk)
        if flat is None:
            flat = jax_variables(jm, np.random.RandomState(3),
                                 jnp.asarray(images[:, :, :64, :64]), jnp.asarray(cams),
                                 is_flow=True, img_scales=(0.25,), inter_scales=(0.75,),
                                 num_virtual_plane=8, kernel_scale=KERNEL_SCALE)
        fn = jax.jit(lambda v, im, cm: jm.apply(v, im, cm, **kw))
        want = {k: np.asarray(v) for k, v in fn(unflatten(flat), jnp.asarray(images),
                                                jnp.asarray(cams)).items()}
        _, model = tt_sweep.build(dtype="float32", chunk_rows=chunk, device="cpu")
        load_jax_variables(model, flat)
        with torch.inference_mode():
            got = model(torch.tensor(images), torch.tensor(cams), **kw)
        out[chunk] = want, {k: v.numpy() for k, v in got.items()}
    return out


@pytest.mark.parametrize("chunk", [0, BAND])
def test_sweep_forward_matches_jax(sweep_forwards, chunk):
    """tests/test_full_parity.py's bars: max |Δdepth| < 0.05, mean < 0.005
    on every stage; confidence max < 0.02; every flow moves the depth."""
    want, got = sweep_forwards[chunk]
    assert sorted(got) == sorted(want)
    for key in ["coarse_depth_map", "flow1", "flow2", "flow3"]:
        diff = np.abs(got[key] - want[key])
        assert diff.max() < 0.05, f"{key}: max|Δdepth| = {diff.max():.4f}"
        assert diff.mean() < 0.005, f"{key}: mean|Δdepth| = {diff.mean():.4f}"
    assert np.abs(got["coarse_prob_map"] - want["coarse_prob_map"]).max() < 0.02
    for it in (1, 2, 3):
        assert np.abs(got[f"flow{it}"] - got[f"flow{it}_input"]).max() > 1e-3


def test_banded_sweep_forward_equals_unbanded(sweep_forwards):
    """Under eval BatchNorm the bands give the unbanded maps bit for bit."""
    for key, a in sweep_forwards[0][1].items():
        np.testing.assert_array_equal(sweep_forwards[BAND][1][key], a, err_msg=key)


# ------------------------------------------------------------------ the sweep

@pytest.mark.parametrize("token,want", [
    ("bilinear:128@640x512", ("bilinear", 128, 640, 512)),
    ("bilinear:0@1920x1024", ("bilinear", 0, 1920, 1024)),
    ("bilinear@1280x1024", ("bilinear", 128, 1280, 1024)),
    ("auto:32@1280x1024", ("auto", 32, 1280, 1024))])
def test_parse_token(token, want):
    assert tt_sweep.parse_token(token) == want


def test_defaults_equal_the_jax_tool():
    tokens, kwargs, iters = jax_sweep_literals()
    assert tt_sweep.DEFAULT_TOKENS == tokens and len(tokens) == 4
    assert tt_sweep.KWARGS == kwargs and tt_sweep.ITERS == iters == 6


class FakeModel:
    def load_state_dict(self, sd):
        pass


@pytest.fixture
def fake_sweep(monkeypatch):
    """tt_sweep without a model: build, weights and inputs stubbed; each
    token's measure calls ``state.measure`` with the token's size
    (default: 2 maps/s, 0.5 s) and is logged in ``state.calls``."""
    calls = []
    state = types.SimpleNamespace(calls=calls, measure=lambda tok: (2.0, 0.5))
    monkeypatch.setattr(tt_sweep, "build", lambda fetch, chunk_rows, device: (None, FakeModel()))
    monkeypatch.setattr(tt_sweep, "init_params", lambda model, gen: {})
    monkeypatch.setattr(tt_sweep, "make_inputs",
                        lambda b, v, h, w, d, device: (torch.zeros(b, v, h // 64, w // 64, 3),
                                                       torch.zeros(b, v, 2, 4, 4)))

    def measure(model, images, cams, kwargs, iters):
        tok = f"{images.shape[3] * 64}x{images.shape[2] * 64}"
        calls.append((tok, iters, kwargs))
        return state.measure(tok)
    monkeypatch.setattr(tt_sweep, "measure", measure)
    return state


def test_sweep_resumes_and_skips_measured_tokens(fake_sweep, tmp_path, capsys):
    out = str(tmp_path / "res" / "sweep.json")
    os.makedirs(os.path.dirname(out))
    with open(out, "w") as f:
        json.dump({"bilinear:128@640x512": {"maps_per_sec": 3.0, "latency_s": 0.3333},
                   "bilinear:64@1280x1024": {"error": "OutOfMemoryError: earlier"}}, f)
    res = tt_sweep.main(["--out", out, "--device", "cpu", "bilinear:128@640x512",
                         "bilinear:64@1280x1024", "bilinear:0@1920x1024"])
    assert [c[0] for c in fake_sweep.calls] == ["1280x1024", "1920x1024"]
    assert all(c[1] == 6 and c[2] is tt_sweep.KWARGS for c in fake_sweep.calls)
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"variant": "bilinear:128@640x512", "skip": "already measured",
                        "maps_per_sec": 3.0, "latency_s": 0.3333}
    assert lines[1] == {"variant": "bilinear:64@1280x1024", "maps_per_sec": 2.0,
                        "latency_s": 0.5}
    with open(out) as f:
        assert json.load(f) == res and len(res) == 3
    tt_sweep.main(["--out", out, "--device", "cpu"] + list(res))
    assert len(fake_sweep.calls) == 2                  # everything measured: nothing runs


def test_sweep_records_oom_and_raises_anything_else(fake_sweep, tmp_path):
    def oom_at_1280(tok):
        if tok == "1280x1024":
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 9 GiB")
        return 2.0, 0.5
    fake_sweep.measure = oom_at_1280
    out = str(tmp_path / "sweep.json")
    res = tt_sweep.sweep(["bilinear:64@1280x1024", "bilinear:128@640x512"], out, "cpu")
    assert res["bilinear:64@1280x1024"] == {
        "error": "OutOfMemoryError: CUDA out of memory. Tried to allocate 9 GiB"}
    assert res["bilinear:128@640x512"] == {"maps_per_sec": 2.0, "latency_s": 0.5}

    def broken(tok):
        raise RuntimeError("not an OOM")
    fake_sweep.measure = broken
    with pytest.raises(RuntimeError, match="not an OOM"):
        tt_sweep.sweep(["bilinear:32@1280x1024"], out, "cpu")
    with open(out) as f:
        assert "bilinear:32@1280x1024" not in json.load(f)


# ------------------------------------------------------------------ measure

class CountingModel:
    def __init__(self, value=1.0):
        self.calls, self.inference, self.value = 0, [], value

    def __call__(self, images, cams, **kwargs):
        self.calls += 1
        self.inference.append(torch.is_inference_mode_enabled())
        return {"coarse_depth_map": torch.ones(1, 2, 2),
                "flow1": torch.ones(1, 2, 2), "flow2_input": torch.ones(1, 4, 4) * np.nan,
                "flow2": torch.full((1, 4, 4), self.value)}


def test_measure_warms_up_then_takes_the_better_of_two_windows(monkeypatch):
    clock = iter([0.0, 3.0, 10.0, 12.0, 20.0, 25.0])       # windows of 3, 2 and 5 s
    monkeypatch.setattr(bench, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
    model = CountingModel()
    mps, dt = bench.measure(model, torch.zeros(2, 3, 64, 64, 3), None, {}, iters=4)
    assert model.calls == 12 and all(model.inference)
    assert dt == 2.0 / 4 and mps == 2 / dt


@pytest.mark.parametrize("value", [float("nan"), float("inf")])
def test_measure_raises_on_a_non_finite_map(value):
    with pytest.raises(FloatingPointError, match="not finite"):
        bench.measure(CountingModel(value), torch.zeros(1, 3, 64, 64, 3), None, {}, iters=1)


# ------------------------------------------------------------------ the card by default

def test_runs_on_cuda_by_default(monkeypatch, tmp_path):
    """No silent CPU fallback: without a GPU the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.make_inputs(1, 2, 64, 64, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt_sweep.main(["bilinear:0@64x64", "--out", str(tmp_path / "sweep.json")])
