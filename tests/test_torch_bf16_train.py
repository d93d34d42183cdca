"""bf16 training of the PyTorch port against the JAX package's
``make_train_step(..., mesh=None)`` with ``MODEL.DTYPE=bfloat16``, BN and
GN, at the tiny config of tests/test_bf16.py (64×128, V=3, D=16, base 4,
EdgeConv (8,), head (8, 1), K=8, one flow at 0.25, B=2, the synthetic
scan 2), the same seeded weights on both sides.

One jitted JAX step per norm serves every test: its optimizer keeps the
step's gradients in its state before RMSprop, so the first step gives the
gradients and the twenty give the loss curve. The port runs the same
twenty steps in bf16 and in f32. The first step's kNN gets the JAX step's
kNN input points on every side, and the reference routes the gradient of
EdgeConv's max over K to the argmax (tests/test_torch_train_step.py says
why).

Bars:
- dtypes: equal, module by module, in the order of the calls;
- losses: rtol 2⁻⁸, one step of bf16's mantissa on the loss;
- BN running statistics: within 2⁻⁷ of each statistic's largest magnitude
  (two bf16 steps: they are f32 moments of bf16 conv outputs);
- gradients: bf16's rounding alone moves the step-1 gradients far from the
  f32 ones in *both* packages at this config (the reference's own bf16
  gradients lie a relative L2 distance of 0.3-0.4 from its f32 ones in the
  median parameter), so a fixed per-element bar cannot tell a fault from
  rounding. Each package's bf16 gradient is held to the f32 gradient
  instead (the port's f32 step, which tests/test_torch_train_step.py holds
  to the JAX package's): over all parameters, the root mean square of the
  port's relative L2 distances at most twice the reference's; each
  parameter's at most 6× the reference's + 0.05 (the two biases right
  before a softmax over the axis they are shared across are left out:
  their gradient is zero in exact arithmetic, rounding in bf16);
- trajectory: the band tests/test_bf16.py holds the JAX package to, for
  the port's bf16 curve against the port's f32 curve; both packages'
  bf16 curves finite and descending.
"""

import re

import flax.linen as flax_nn
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
from pointmvsnet_tpu.utils.solver import build_optimizer as jbuild_optimizer
from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.dataset.dtu import DTUTrainValDataset
from pointmvsnet_tpu_torch.dataset.synthetic import make_synthetic_dtu
from pointmvsnet_tpu_torch.models import build_loss_fn, build_model
from pointmvsnet_tpu_torch.parallel import TrainState, make_train_step
from pointmvsnet_tpu_torch.utils.convert import jax_to_torch, load_jax_variables
from pointmvsnet_tpu_torch.utils.solver import build_optimizer
from test_torch_model import flatten, jax_variables, unflatten
from test_torch_train_step import ArgmaxRoutedNumpy
from torch_threads import one_torch_thread  # noqa: F401

B, V, H, W, D = 2, 3, 64, 128, 16
KW = dict(is_flow=True, img_scales=(0.25,), inter_scales=(0.75,), num_virtual_plane=D)
N_STEPS = 20
LOSS_RTOL = 2.0 ** -8
STATS_BAR = 2.0 ** -7
GRAD_RMS_FACTOR, GRAD_FACTOR, GRAD_FLOOR = 2.0, 6.0, 0.05
# zero in exact arithmetic: the softmax over depth planes / hypotheses
# does not see a bias added to all of them
SHIFT_INVARIANT = ("vol_conv.convs.7.conv.bias", "point_flow.head.layers.1.linear.bias")
# JAX module path → the port's module, for the dtype of every output
MODULES = [(r"", ""), (r"img_conv", "img_conv"), (r"img_conv/ConvBlock_(\d+)", "img_conv.blocks.{}"),
           (r"vol_conv", "vol_conv"), (r"vol_conv/ConvBlock_(\d+)", "vol_conv.convs.{}"),
           (r"vol_conv/DeconvBlock_(\d+)", "vol_conv.deconvs.{}"), (r"point_flow", "point_flow"),
           (r"point_flow/core/EdgeConv_(\d+)", "point_flow.edge_convs.{}"),
           (r"point_flow/core/SharedMLP_0", "point_flow.head")]


def tiny(cfg, norm, dtype):
    cfg.MODEL.IMG_BASE_CHANNELS = 4
    cfg.MODEL.VOL_BASE_CHANNELS = 4
    cfg.MODEL.EDGE_CHANNELS = (8,)
    cfg.MODEL.FLOW_CHANNELS = (8, 1)
    cfg.MODEL.KNN = 8
    cfg.MODEL.NUM_VIRTUAL_PLANE = D
    cfg.MODEL.NORM = norm
    cfg.MODEL.DTYPE = dtype
    return cfg


def port_module(path: str):
    for pat, name in MODULES:
        m = re.fullmatch(pat, path)
        if m:
            return name.format(*m.groups())
    return None


def dtype_tree(out):
    if isinstance(out, dict):
        return {k: dtype_tree(v) for k, v in out.items()}
    return str(out.dtype).removeprefix("torch.")


def record_grads() -> optax.GradientTransformation:
    """State ← the gradients; updates unchanged."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


def run_jax(norm, batch, flat):
    """Twenty bf16 steps of the JAX package → (step-1 result, curve, the
    step-1 kNN input points, the dtypes of every module's outputs)."""
    cfg = tiny(jget_default_cfg(), norm, "bfloat16")
    jm, jloss, _ = jbuild_model(cfg)
    opt = optax.chain(record_grads(), jbuild_optimizer(cfg, steps_per_epoch=10))
    variables = unflatten(flat)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                        batch_stats=variables.get("batch_stats", {}),
                        opt_state=opt.init(variables["params"]))
    points, dtypes = [], {}
    jknn = jpointmvsnet.window_knn_auto

    def recording_knn(pts, *args, **kwargs):
        jax.debug.callback(lambda p: points.append(np.array(p)), pts)
        return jknn(pts, *args, **kwargs)

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        name = port_module("/".join(context.module.path))
        if context.method_name == "__call__" and name is not None:
            dtypes.setdefault(name, []).append(dtype_tree(out))
        return out

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    curve = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpointmvsnet, "window_knn_auto", recording_knn)
        mp.setattr(jedge_conv, "jnp", ArgmaxRoutedNumpy())
        jstep = jmake_train_step(jm, jloss, opt, None, KW)
        with flax_nn.intercept_methods(interceptor):
            state, losses = jstep(state, jbatch)
        first = dict(losses={k: float(v) for k, v in losses.items()},
                     grads=jax_to_torch({f"params/{k.removeprefix('g/')}": np.asarray(v)
                                         for k, v in flatten({"g": state.opt_state[0]}).items()}),
                     stats=jax_to_torch(flatten({"batch_stats": state.batch_stats})))
        curve.append(first["losses"]["total_loss"])
        for _ in range(N_STEPS - 1):
            state, losses = jstep(state, jbatch)
            curve.append(float(losses["total_loss"]))
        jax.effects_barrier()
    return first, np.asarray(curve), points[0], dtypes


def run_port(norm, dtype, batch, flat, knn_points):
    """Twenty steps of the port, the first one's kNN fed ``knn_points``
    → (step-1 result, curve, the dtypes of every module's outputs in the
    first step)."""
    cfg = tiny(get_default_cfg(), norm, dtype)
    model = build_model(cfg, "cpu")
    load_jax_variables(model, flat)
    state = TrainState(model, build_optimizer(cfg, dict(model.named_parameters()), 10))
    step = make_train_step(build_loss_fn(cfg), KW)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    dtypes = {}

    def record(name):
        def hook(module, args, out):
            dtypes.setdefault(name, []).append(dtype_tree(out))
        return hook

    names = [re.compile(re.escape(name).replace(r"\{\}", r"\d+")) for _, name in MODULES]
    hooks = [m.register_forward_hook(record(n)) for n, m in model.named_modules()
             if any(p.fullmatch(n) for p in names)]
    tknn = tpointmvsnet.window_knn_idx
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpointmvsnet, "window_knn_idx",
                   lambda pts, *args: tknn(torch.from_numpy(knn_points), *args))
        state, losses = step(state, tbatch)
    for h in hooks:
        h.remove()
    first = dict(losses={k: float(v) for k, v in losses.items()},
                 grads={n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
                        for n, p in model.named_parameters()},
                 stats={n: b.clone() for n, b in model.named_buffers() if "running" in n},
                 applied=state.optimizer.count)
    curve = [first["losses"]["total_loss"]]
    for _ in range(N_STEPS - 1):
        state, losses = step(state, tbatch)
        curve.append(float(losses["total_loss"]))
    return first, np.asarray(curve), dtypes


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """Items 0 and 1 of the synthetic scan 2 (tests/test_bf16.py's batch)."""
    root = str(tmp_path_factory.mktemp("dtu_bf16"))
    make_synthetic_dtu(root, scans=[2], num_views=V, height=H, width=W, num_depth=D,
                       depth_min=425.0, depth_interval=2.5)
    ds = DTUTrainValDataset(root, mode="train", num_view=V, num_virtual_plane=D,
                            interval_scale=1.0)
    items = [ds[i] for i in range(B)]
    return {k: np.stack([it[k] for it in items]) for k in ("images", "cams", "gt_depth")}


@pytest.fixture(scope="module", params=["bn", "gn"])
def runs(request, batch):
    """→ norm, {"jax": (first, curve, dtypes), "bf16": ..., "f32": ...}."""
    norm = request.param
    jm, _, _ = jbuild_model(tiny(jget_default_cfg(), norm, "bfloat16"))
    flat = jax_variables(jm, np.random.RandomState(11), jnp.asarray(batch["images"][:, :, :64, :64]),
                         jnp.asarray(batch["cams"]), **dict(KW, num_virtual_plane=8))
    first, curve, points, jdtypes = run_jax(norm, batch, flat)
    out = {"jax": (first, curve, jdtypes)}
    for dtype, key in (("bfloat16", "bf16"), ("float32", "f32")):
        out[key] = run_port(norm, dtype, batch, flat, points)
    return norm, out


def test_bf16_dtypes(runs):
    """Every module output of the JAX package's bf16 train step has the
    port's dtype: train-mode norms return f32 (so the ImageConv features
    that enter the cost volume are f32), convs, dense layers and BN
    EdgeConvs the compute dtype, the predictions f32."""
    norm, out = runs
    want, got = out["jax"][2], out["bf16"][2]
    assert sorted(want) == sorted(got)
    for name in want:
        assert got[name] == want[name], name
    assert want["img_conv"][0]["conv2"] == "float32"            # the cost volume's input
    assert want[""][0] == {k: "float32" for k in want[""][0]}   # every prediction
    assert want["point_flow.edge_convs.0"][0] == ("bfloat16" if norm == "bn" else "float32")


def test_bf16_losses(runs):
    _, out = runs
    want, got = out["jax"][0]["losses"], out["bf16"][0]["losses"]
    assert out["bf16"][0]["applied"] == 1 and got["skipped_steps"] == 0
    for k, v in want.items():
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)


def test_bf16_gradients(runs):
    _, out = runs
    jax_g, port_g = out["jax"][0]["grads"], out["bf16"][0]["grads"]
    ref = out["f32"][0]["grads"]
    assert sorted(jax_g) == sorted(port_g) == sorted(ref)
    d_port, d_jax = [], []
    for name, g32 in ref.items():
        assert torch.isfinite(port_g[name]).all(), name
        if name in SHIFT_INVARIANT:
            continue
        norm = float(g32.norm())
        if norm == 0:                           # ImageConv's conv3 blocks: no output uses them
            assert float(port_g[name].abs().max()) == float(jax_g[name].abs().max()) == 0, name
            continue
        dp = float((port_g[name] - g32).norm()) / norm
        dj = float((jax_g[name] - g32).norm()) / norm
        assert dp <= GRAD_FACTOR * dj + GRAD_FLOOR, f"{name}: port {dp:.3f}, JAX {dj:.3f}"
        d_port.append(dp)
        d_jax.append(dj)
    rms_port, rms_jax = np.sqrt(np.mean(np.square(d_port))), np.sqrt(np.mean(np.square(d_jax)))
    assert rms_port <= GRAD_RMS_FACTOR * rms_jax, (rms_port, rms_jax)


def test_bf16_bn_running_stats(runs):
    norm, out = runs
    want, got = out["jax"][0]["stats"], out["bf16"][0]["stats"]
    assert sorted(want) == sorted(got) and bool(want) == (norm == "bn")
    for name, v in want.items():
        bar = STATS_BAR * float(v.abs().max())
        assert float((got[name] - v).abs().max()) <= bar, name


def test_bf16_trajectory(runs):
    """tests/test_bf16.py's band for the port's bf16 curve against its f32
    curve; both packages' bf16 curves finite and descending."""
    _, out = runs
    jax16, bf16, f32 = out["jax"][1], out["bf16"][1], out["f32"][1]
    for curve in (jax16, bf16, f32):
        assert np.isfinite(curve).all()
        assert curve[-3:].mean() < 0.75 * curve[:3].mean()
    drift = np.abs(bf16 - f32) / np.maximum(np.abs(f32), 1e-6)
    assert drift[0] < 0.02
    assert drift.max() < 0.35
    assert bf16[-3:].mean() < 1.25 * f32[-3:].mean()
