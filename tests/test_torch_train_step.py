"""One whole train step of a tiny PointMVSNet (BatchNorm, base 4, EdgeConv
(8, 8), flows at 0.25 and 0.5 of a 64×128 input, V=3, D=16, B=2) in the
PyTorch port against the JAX package's ``make_train_step(..., mesh=None)``,
same weights and batch: the coarse-only step of the curriculum's first
epochs and the step with both flows. The JAX step runs with an optimizer
that keeps the gradients as its state and leaves the parameters alone, so
both sides give their gradients; the port's step runs its real optimizer,
whose first RMSprop update (≈ lr·√10·sign(g)) would turn noise in tiny
gradients into differences, which is why the gradients are compared.

The third case bands the flows as ``MODEL.FLOW_CHUNK_ROWS`` 8 does in
both packages: flow1's 16 rows are too few to band (≤ 8 + 2·8), flow2's 32
rows go in 4 bands of 8 kept rows and 24 refined, each band with its own
BatchNorm batch statistics and its own blend of the running statistics,
in band order; the JAX step's 5 kNN input point sets feed the port's 5
kNN calls in order.

Tolerances: losses rtol 1e-4; BN running statistics atol 1e-5; every
gradient within 1e-4 of its parameter's max |g| in the coarse-only step
and within 1e-2 with the flows on, except the two biases right before a
softmax over the axis they are shared across, whose gradient is zero up
to rounding in both packages.

With the flows on:
- both kNNs see the JAX step's kNN input points, so the neighbour graphs
  are the same (given the same points the port's kNN equals the JAX one
  bit for bit, tests/test_torch_knn.py);
- the reference routes the gradient of EdgeConv's max over K to the
  argmax. ``jnp.max``'s own gradient (a mask of the elements equal to the
  max, divided by their count) gives EdgeConv gradients in the jitted
  step on the CPU that central differences of the loss refute, and NaN
  with XLA's optimizations off; the same JAX code run op by op
  (``jax.disable_jit``) agrees with the port, but takes two minutes;
- the images carry seeded noise (σ = 3 on standardized images): on the
  smooth synthetic texture dozens of maxima over K are tied to within
  1e-6 of their value;
- the bar is 1e-2 of max |g|: the two packages' f32 results differ by a
  few 1e-6 relative (EdgeConv's inputs agree to 4e-6), which flips some
  of the remaining near-tied maxima, and each flip sends a gradient to
  another neighbour. Over five noise draws the largest difference was
  6.8e-3 of max |g|; a zero or sign-flipped gradient is off by at least
  max |g|. EdgeConv's backward alone is held at 1e-4 of max |g|
  (tests/test_torch_train.py::test_edge_conv_train_gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pointmvsnet_tpu.models.edge_conv as jedge_conv
import pointmvsnet_tpu.models.pointmvsnet as jpointmvsnet
import pointmvsnet_tpu_torch.models.pointmvsnet as tpointmvsnet
from pointmvsnet_tpu.config import get_default_cfg as jget_default_cfg
from pointmvsnet_tpu.models import build_model as jbuild_model
from pointmvsnet_tpu.parallel.train_step import TrainState as JTrainState
from pointmvsnet_tpu.parallel.train_step import make_train_step as jmake_train_step
from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch
from pointmvsnet_tpu_torch.models import build_loss_fn, build_model
from pointmvsnet_tpu_torch.parallel import TrainState, make_train_step
from pointmvsnet_tpu_torch.utils.convert import jax_to_torch, load_jax_variables
from pointmvsnet_tpu_torch.utils.solver import build_optimizer
from test_torch_model import flatten, jax_variables, unflatten
from torch_threads import one_torch_thread  # noqa: F401

B, V, H, W, D = 2, 3, 64, 128, 16
KW = dict(is_flow=True, img_scales=(0.25, 0.5), inter_scales=(0.75, 0.375),
          num_virtual_plane=D)
# ×1.5: enough that the flow head's softmax is not flat, inside the ×2 of
# tests/test_torch_model.py past which the reference itself is unstable
KERNEL_SCALE = 1.5
IMAGE_NOISE = 3.0
GRAD_BAR = {False: 1e-4, True: 1e-2}          # of max |g|, by is_flow
# zero in exact arithmetic: the softmax over depth planes / hypotheses
# does not see a bias added to all of them
SHIFT_INVARIANT = ("vol_conv.convs.7.conv.bias", "point_flow.head.layers.1.linear.bias")


BAND_ROWS = 8          # FLOW_CHUNK_ROWS of the banded case
N_KNN = {"coarse": 0, "flow": 2, "banded": 1 + 4}


def tiny(cfg, chunk_rows: int = -1):
    cfg.MODEL.FLOW_CHUNK_ROWS = chunk_rows
    cfg.MODEL.IMG_BASE_CHANNELS = 4
    cfg.MODEL.VOL_BASE_CHANNELS = 4
    cfg.MODEL.EDGE_CHANNELS = (8, 8)
    cfg.MODEL.FLOW_CHANNELS = (8, 1)
    cfg.MODEL.NUM_VIRTUAL_PLANE = D
    cfg.MODEL.MASKED_LOSS = False      # every flow pixel in the loss
    return cfg


def keep_grads() -> optax.GradientTransformation:
    """State ← the gradients; zero updates."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


class ArgmaxRoutedNumpy:
    """``jax.numpy`` whose ``max`` sends its gradient to the argmax, for
    the JAX EdgeConv module's global ``jnp``."""

    @staticmethod
    def max(x, axis):
        i = jnp.expand_dims(jnp.argmax(x, axis=axis), axis)
        return jnp.take_along_axis(x, i, axis=axis).squeeze(axis)

    def __getattr__(self, name):
        return getattr(jnp, name)


def run_jax(kw, images, cams, gt, flat, chunk_rows=-1):
    """The JAX step on the batch → (result, the kNN input points)."""
    jm, jloss, _ = jbuild_model(tiny(jget_default_cfg(), chunk_rows))
    knn_points = []

    def recording_knn(points, *args, **kwargs):
        jax.debug.callback(lambda p: knn_points.append(np.array(p)), points, ordered=True)
        return jknn(points, *args, **kwargs)

    jknn = jpointmvsnet.window_knn_auto
    variables = unflatten(flat)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                         batch_stats=variables["batch_stats"],
                         opt_state=keep_grads().init(variables["params"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpointmvsnet, "window_knn_auto", recording_knn)
        mp.setattr(jedge_conv, "jnp", ArgmaxRoutedNumpy())
        jstep = jmake_train_step(jm, jloss, keep_grads(), None, kw)
        jnew, jlosses = jstep(jstate, {"images": jnp.asarray(images), "cams": jnp.asarray(cams),
                                       "gt_depth": jnp.asarray(gt)})
        jax.effects_barrier()
    return dict(losses={k: float(v) for k, v in jlosses.items()},
                grads=jax_to_torch({f"params/{k.removeprefix('g/')}": np.asarray(v)
                                    for k, v in flatten({"g": jnew.opt_state}).items()}),
                stats=jax_to_torch(flatten({"batch_stats": jnew.batch_stats})),
                step=int(jnew.step)), knn_points


def run_port(kw, images, cams, gt, flat, knn_points, chunk_rows=-1):
    """The port's step on the same batch, its kNN fed ``knn_points`` (its
    own kNN for None)."""
    tknn = tpointmvsnet.window_knn_idx
    cfg = tiny(get_default_cfg(), chunk_rows)
    model = build_model(cfg, device="cpu")
    load_jax_variables(model, flat)
    state = TrainState(model, build_optimizer(cfg, dict(model.named_parameters())))
    with pytest.MonkeyPatch.context() as mp:
        if knn_points is not None:
            mp.setattr(tpointmvsnet, "window_knn_idx",
                       lambda points, *args: tknn(torch.from_numpy(knn_points.pop(0)), *args))
        state, losses = make_train_step(build_loss_fn(cfg), kw)(
            state, {"images": torch.tensor(images), "cams": torch.tensor(cams),
                    "gt_depth": torch.tensor(gt)})
    assert not knn_points
    return dict(losses={k: float(v) for k, v in losses.items()},
                grads={n: p.grad for n, p in model.named_parameters()},
                stats=model.state_dict(), step=state.step, applied=state.optimizer.count)


@pytest.fixture(scope="module")
def batch():
    images, cams, gt = make_scene_batch(B, V, H, W, D, seed=5)
    images = images + IMAGE_NOISE * np.random.RandomState(7).randn(*images.shape)
    jm, _, _ = jbuild_model(tiny(jget_default_cfg()))
    flat = jax_variables(jm, np.random.RandomState(6), jnp.asarray(images[:, :, :64, :64]),
                         jnp.asarray(cams), is_flow=True, img_scales=(0.25,),
                         inter_scales=(0.75,), num_virtual_plane=8,
                         kernel_scale=KERNEL_SCALE)
    return images.astype(np.float32), cams, gt[..., None], flat


@pytest.fixture(scope="module", params=["coarse", "flow", "banded"])
def steps(request, batch):
    """→ (JAX result, port result, is_flow)."""
    is_flow = request.param != "coarse"
    cr = BAND_ROWS if request.param == "banded" else -1
    kw = dict(KW, is_flow=is_flow)
    want, knn_points = run_jax(kw, *batch, chunk_rows=cr)
    assert len(knn_points) == N_KNN[request.param]
    return want, run_port(kw, *batch, knn_points, chunk_rows=cr), is_flow


def test_losses(steps):
    want, got, is_flow = steps
    assert want["step"] == got["step"] == 1 and got["applied"] == 1
    assert got["losses"]["skipped_steps"] == 0
    assert sorted(want["losses"]) == sorted(k for k in got["losses"]
                                            if k not in ("skipped_steps", "consecutive_skipped"))
    for k, v in want["losses"].items():
        assert np.isfinite(got["losses"][k]), k
        np.testing.assert_allclose(got["losses"][k], v, rtol=1e-4, err_msg=k)
    if is_flow:
        assert want["losses"]["flow1_loss"] > 0 and want["losses"]["flow2_loss"] > 0


def test_gradients(steps):
    want, got, is_flow = steps
    assert sorted(want["grads"]) == sorted(got["grads"])
    largest = max(float(g.abs().max()) for g in want["grads"].values())
    for name, g in want["grads"].items():
        # no gradient in the port where JAX's is zero: parameters no output
        # uses (ImageConv's conv3 blocks; PointFlow in the coarse-only step)
        tg = got["grads"][name]
        tg = torch.zeros_like(g) if tg is None else tg
        if name in SHIFT_INVARIANT:
            assert max(float(g.abs().max()), float(tg.abs().max())) < 1e-5 * largest, name
            continue
        bar = GRAD_BAR[is_flow] * float(g.abs().max())
        diff = float((tg - g).abs().max())
        assert diff <= bar, f"{name}: max |Δg| {diff:.3e}, bar {bar:.3e}"
    edge = [n for n in want["grads"] if n.startswith("point_flow.edge_convs.")]
    assert all((float(want["grads"][n].abs().max()) > 0) == is_flow for n in edge)


def test_bn_running_stats(steps):
    want, got, _ = steps
    assert want["stats"]
    for name, v in want["stats"].items():
        np.testing.assert_allclose(got["stats"][name].numpy(), v.numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)


def test_banded_step_differs_from_unbanded(batch):
    """The bands change the step: the port's banded step (its own kNN)
    differs from its unbanded one by more than the bars above, in the BN
    running statistics (four blends of flow2's per-band statistics) and in
    the gradients; so a port that ignored the bands in training would fail
    the banded case."""
    kw = dict(KW, is_flow=True)
    banded = run_port(kw, *batch, None, chunk_rows=BAND_ROWS)
    plain = run_port(kw, *batch, None, chunk_rows=0)
    stats = max(float((banded["stats"][n] - v).abs().max())
                for n, v in plain["stats"].items() if "running" in n)
    assert stats > 1e-5
    largest = max(float(g.abs().max()) for g in plain["grads"].values() if g is not None)
    gaps = [float((banded["grads"][n] - g).abs().max()) / float(g.abs().max())
            for n, g in plain["grads"].items()
            if g is not None and float(g.abs().max()) > 1e-3 * largest]
    assert max(gaps) > GRAD_BAR[True]


def test_band_group_in_training_raises():
    """Band-parallel flow is eval only, as in the JAX package, whose
    training builds no band mesh."""
    flow = tpointmvsnet.PointFlow(4, (4,), (4, 1), k=4).train()
    with pytest.raises(ValueError, match="eval-only"):
        tpointmvsnet.banded_point_flow(flow, [], [], None, torch.zeros(1, 40, 8), None, 8,
                                       band_group=object())
