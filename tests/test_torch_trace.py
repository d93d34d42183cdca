"""The port's profiler spans (``utils/profiler.py::span``) on the CPU:
a shared no-op with no profiler recording; under ``torch.profiler`` the
``pmvs.`` ranges of a ``Predictor`` call (the four predictor phases, the
model's stages inside ``predictor.model``, PointFlow's four phases inside
each flow, per band where banded) and of a train step, one group per
request in order; the same outputs with the profiler on and off; and ``trace(log_dir)``'s
Chrome trace holding the spans. Tiny model (BN, base 4, EdgeConv (8,),
flows at 0.25, 0.5 and 1.0 of a 64×128 input, V=2, D=8)."""

import copy
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
from pointmvsnet_tpu_torch.models import build_loss_fn, build_model
from pointmvsnet_tpu_torch.parallel import TrainState, make_train_step
from pointmvsnet_tpu_torch.predictor import Predictor
from pointmvsnet_tpu_torch.utils import profiler
from pointmvsnet_tpu_torch.utils.solver import build_optimizer
from torch_threads import one_torch_thread  # noqa: F401

FLOWS = 3
PHASES = ("point_flow.fetch", "point_flow.knn", "point_flow.edge_conv", "point_flow.head")
PREDICTOR = ("predictor.prepare", "predictor.to_device", "predictor.model",
             "predictor.to_host")
TRAIN = ("train_step.forward", "train_step.loss", "train_step.backward",
         "train_step.optimizer")


def small_cfg(chunk_rows: int = 0):
    cfg = get_default_cfg()
    cfg.MODEL.IMG_BASE_CHANNELS = 4
    cfg.MODEL.VOL_BASE_CHANNELS = 4
    cfg.MODEL.EDGE_CHANNELS = (8,)
    cfg.MODEL.FLOW_CHANNELS = (8, 1)
    cfg.MODEL.FLOW_CHUNK_ROWS = chunk_rows
    cfg.MODEL.TEST.IMG_SCALES = (0.25, 0.5, 1.0)
    cfg.MODEL.TEST.INTER_SCALES = (0.75, 0.375, 0.1875)
    cfg.DATA.TEST.NUM_VIRTUAL_PLANE = 8
    return cfg


@pytest.fixture(scope="module")
def request_data():
    images, cams, _ = make_scene_batch(1, 2, 64, 128, 8, depth_interval=2.5, seed=3)
    return (images[0] * 40 + 128).astype(np.float32), cams[0]


@pytest.fixture(scope="module")
def predictors():
    """Unbanded, and at ``FLOW_CHUNK_ROWS`` 16: flow3's 64 rows in 4 bands
    (flow1's 16 and flow2's 32 rows are too few to band)."""
    weights = build_model(small_cfg(), "cpu").state_dict()
    return {rows: Predictor(small_cfg(rows), state_dict=weights, device="cpu")
            for rows in (0, 16)}


@pytest.fixture(scope="module")
def train_setup():
    cfg = small_cfg()
    cfg.TRAIN.BATCH_SIZE = 2
    torch.manual_seed(0)
    model = build_model(cfg, "cpu")
    images, cams, gt = make_scene_batch(2, 2, 64, 64, 8, seed=1)
    batch = {"images": torch.from_numpy(images), "cams": torch.from_numpy(cams),
             "gt_depth": torch.from_numpy(gt[..., None])}
    kwargs = dict(is_flow=True, img_scales=(0.25, 0.5), inter_scales=(0.75, 0.375),
                  num_virtual_plane=8)
    state = TrainState(model, build_optimizer(cfg, dict(model.named_parameters())))
    return state, make_train_step(build_loss_fn(cfg), kwargs), batch


def profiled(fn, tmp_path):
    """``fn()`` under ``torch.profiler`` → (its result, the ``pmvs.`` ranges
    of the Chrome trace as (name less the prefix, start, end), by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return out, spans_of(path)


def spans_of(path):
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"][len("pmvs."):], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("pmvs.")]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def inside(spans, outer):
    """The spans that lie within ``outer`` (a span of the list), itself not."""
    _, a, b = outer
    return [s for s in spans if s is not outer and a <= s[1] and s[2] <= b]


def named(spans, name):
    return [s for s in spans if s[0] == name]


def test_span_is_a_shared_noop_without_a_profiler(monkeypatch, predictors, request_data,
                                                  train_setup):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiler.span("a") is profiler.span("b")
    predictors[16](*request_data)
    state, step, batch = train_setup
    step(copy.deepcopy(state), batch)


@pytest.mark.parametrize("rows", [0, 16])
def test_predictor_spans_nest(rows, predictors, request_data, tmp_path):
    pred = predictors[rows]
    _, spans = profiled(lambda: pred(*request_data), tmp_path)

    # the four phases once each, in order
    tops = [s for s in spans if s[0].startswith("predictor.")]
    assert [s[0] for s in tops] == list(PREDICTOR)

    # the model's stages inside predictor.model, nothing inside the others
    model = named(spans, "predictor.model")[0]
    stages = [s[0] for s in inside(spans, model) if s[0].startswith("model.")]
    assert stages == ["model.coarse"] + [f"model.flow{n}" for n in range(1, FLOWS + 1)]
    for other in ("predictor.prepare", "predictor.to_device", "predictor.to_host"):
        assert inside(spans, named(spans, other)[0]) == []
    assert inside(spans, named(spans, "model.coarse")[0]) == []

    # PointFlow's four phases inside each flow: once, or once per band
    bands = {1: 1, 2: 1, 3: 4 if rows else 1}
    for n in range(1, FLOWS + 1):
        flow = named(spans, f"model.flow{n}")[0]
        phases = [s[0] for s in inside(spans, flow)]
        assert phases == list(PHASES) * bands[n], (n, phases)


def test_two_requests_are_two_groups_of_spans(predictors, request_data, tmp_path):
    """Two calls under one profiler: each call's four phases follow one
    another, and each call's model spans lie inside its own
    ``predictor.model``."""
    pred = predictors[0]
    _, spans = profiled(lambda: (pred(*request_data), pred(*request_data)), tmp_path)
    tops = [s for s in spans if s[0].startswith("predictor.")]
    assert [s[0] for s in tops] == list(PREDICTOR) * 2
    assert tops[3][2] <= tops[4][1]
    stages = ["model.coarse"] + [f"model.flow{n}" for n in range(1, FLOWS + 1)]
    models = named(spans, "predictor.model")
    for model in models:
        assert [s[0] for s in inside(spans, model) if s[0].startswith("model.")] == stages
    assert len(named(spans, "model.coarse")) == 2
    assert len(named(spans, "point_flow.fetch")) == 2 * FLOWS


def test_train_step_spans(train_setup, tmp_path):
    state, step, batch = train_setup
    state = copy.deepcopy(state)
    state.step = 7
    _, spans = profiled(lambda: step(state, batch), tmp_path)
    assert [s[0] for s in spans if s[0].startswith("train_step.")] == list(TRAIN)
    forward = named(spans, "train_step.forward")[0]
    assert [s[0] for s in inside(spans, forward) if s[0].startswith("model.")] == \
        ["model.coarse", "model.flow1", "model.flow2"]
    for name in ("train_step.loss", "train_step.optimizer"):
        assert inside(spans, named(spans, name)[0]) == []
    assert state.step == 8


@pytest.mark.parametrize("rows", [0, 16])
def test_predictor_outputs_equal_with_the_profiler(rows, predictors, request_data, tmp_path):
    pred = predictors[rows]
    off = pred(*request_data)
    on, spans = profiled(lambda: pred(*request_data), tmp_path)
    assert spans
    assert sorted(on) == sorted(off)
    for k in off:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)


def test_train_step_equal_with_the_profiler(train_setup, tmp_path):
    state, step, batch = train_setup
    a, b = copy.deepcopy(state), copy.deepcopy(state)
    _, out_off = step(a, batch)
    (_, out_on), spans = profiled(lambda: step(b, batch), tmp_path)
    assert spans
    for k in out_off:
        assert torch.equal(torch.as_tensor(out_on[k]), torch.as_tensor(out_off[k])), k
    for (n, p), (_, q) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(p, q), n
    for n, slot in a.optimizer.slots.items():
        assert torch.equal(slot["nu"], b.optimizer.slots[n]["nu"]), n


def test_trace_writes_the_spans(predictors, request_data, tmp_path):
    with profiler.trace(str(tmp_path / "tb")):
        predictors[0](*request_data)
    names = {s[0] for s in spans_of(tmp_path / "tb" / "trace.json")}
    assert names == set(PREDICTOR) | set(PHASES) | {"model.coarse"} | {
        f"model.flow{n}" for n in range(1, FLOWS + 1)}
