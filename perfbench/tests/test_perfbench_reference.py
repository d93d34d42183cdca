"""The frozen reference against the measured program's CPU path (its plain
kNN and masked max) at 64x128, f32, on the benchmark's own weights."""

import numpy as np
import pytest
import torch

from perfbench import inputs
from perfbench.check import FLOWS
from perfbench.drivers import common
from perfbench.drivers.train import make_batches, reference_steps
from perfbench.reference.model import request_inputs
from tiny import tiny_cell

CPU = torch.device("cpu")


def test_eval_forward_matches_the_program():
    from pointmvsnet_tpu_torch.predictor import Predictor

    cell = tiny_cell("dtu-serve")
    cell.config["eval"]["dtype"] = "float32"
    b = cell.config["eval"]
    frames, cams, _ = inputs.scene_pool(7, 1, b["views"], b["height"], b["width"],
                                        b["num_depth"])[0]
    weights = common.seeded_weights(cell.config, 7, CPU, calibrate=True)
    got = Predictor(common.program_cfg(cell.config, "eval"), state_dict=weights,
                    device="cpu")(frames, cams)
    images, cms = request_inputs(frames, cams)
    want = common.reference_maps(common.reference(cell.config, weights, CPU), images, cms,
                                 common.forward_kwargs(b))
    assert set(want) <= set(got)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=2e-4, err_msg=key)


def test_train_steps_match_the_program():
    from pointmvsnet_tpu_torch.models import build_loss_fn, build_model
    from pointmvsnet_tpu_torch.parallel.train_step import TrainState, make_train_step
    from pointmvsnet_tpu_torch.utils.solver import build_optimizer

    cell = tiny_cell("dtu-train")
    b = cell.config["train"]
    batches = make_batches(11, b, cell.traffic, CPU)
    weights = common.seeded_weights(cell.config, 11, CPU)
    cfg = common.program_cfg(cell.config, "train")
    model = build_model(cfg, "cpu")
    model.load_state_dict(weights)
    state = TrainState(model, build_optimizer(cfg, dict(model.named_parameters()), 1000))
    step = make_train_step(build_loss_fn(cfg), common.forward_kwargs(b))
    losses = [float(step(state, batches[i])[1]["total_loss"]) for i in range(3)]
    ref, raw = reference_steps(cell.config, weights, batches, common.forward_kwargs(b), CPU)
    np.testing.assert_allclose(losses, ref.losses, rtol=1e-5)
    assert min(raw.values()) >= 0 and np.median(list(raw.values())) > 0


@pytest.mark.parametrize("precision", ["bf16", "tf32", "fp8"])
def test_lower_precisions_move_the_forward(precision):
    cell = tiny_cell("dtu-serve")
    b = cell.config["eval"]
    scene = inputs.scene_pool(3, 1, b["views"], b["height"], b["width"], b["num_depth"])[0]
    weights = common.seeded_weights(cell.config, 3, CPU)
    images, cms = request_inputs(scene[0], scene[1])
    kw = common.forward_kwargs(b)
    ref = common.reference_maps(common.reference(cell.config, weights, CPU), images, cms, kw)
    low = common.reference_maps(common.reference(cell.config, weights, CPU, precision),
                                images, cms, kw)
    gap = np.abs(low["flow3"] - ref["flow3"]).mean()
    assert 0 < gap < 1.0


def test_calibrated_pointflow_steps_and_following_reproduces_it():
    """With the eval cells' calibrated weights every flow iteration moves
    the depth, and the reference started from its own flow inputs gives
    its own flows back."""
    cell = tiny_cell("dtu-serve")
    b = cell.config["eval"]
    frames, cams, _ = inputs.scene_pool(5, 1, b["views"], b["height"], b["width"],
                                        b["num_depth"])[0]
    net = common.reference(cell.config, common.seeded_weights(cell.config, 5, CPU,
                                                              calibrate=True), CPU)
    images, cms = request_inputs(frames, cams)
    kw = common.forward_kwargs(b)
    out = common.reference_maps(net, images, cms, kw)
    interval = float(cms[0, 0, 1, 3, 1])
    for f in FLOWS:
        assert np.abs(out[f] - out[f"{f}_input"]).mean() > 1e-3 * interval, f
    starts = [torch.from_numpy(out[f"{f}_input"])[None] for f in FLOWS]
    followed = common.reference_maps(net, images, cms, dict(kw, flow_inputs=starts))
    assert "coarse_depth_map" not in followed
    for f in FLOWS:
        np.testing.assert_array_equal(followed[f], out[f])
