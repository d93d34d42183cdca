"""The training pieces of the PyTorch port vs the JAX package: loss and
metrics, the optimizer (optax semantics), train-mode BatchNorm in every
module that has it (flax semantics, running statistics included), and the
port's ``train()`` loop on a tiny synthetic tree (curriculum, checkpoint,
auto-resume). The port runs on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointmvsnet_tpu.config import get_default_cfg as jget_default_cfg
from pointmvsnet_tpu.models.blocks import SharedMLP as JSharedMLP
from pointmvsnet_tpu.models.edge_conv import EdgeConv as JEdgeConv
from pointmvsnet_tpu.models.image_conv import ImageConv as JImageConv
from pointmvsnet_tpu.models.loss import pointmvsnet_loss as jloss
from pointmvsnet_tpu.models.loss import pointmvsnet_metrics as jmetrics
from pointmvsnet_tpu.models.volume_conv import VolumeConv as JVolumeConv
from pointmvsnet_tpu.utils.solver import build_optimizer as jbuild_optimizer
from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.dataset.synthetic import make_synthetic_dtu
from pointmvsnet_tpu_torch.models.blocks import SharedMLP
from pointmvsnet_tpu_torch.models.edge_conv import EdgeConv
from pointmvsnet_tpu_torch.models.image_conv import ImageConv
from pointmvsnet_tpu_torch.models.loss import pointmvsnet_loss, pointmvsnet_metrics
from pointmvsnet_tpu_torch.models.volume_conv import VolumeConv
from pointmvsnet_tpu_torch.ops.knn import window_knn
from pointmvsnet_tpu_torch.utils.convert import jax_to_torch
from pointmvsnet_tpu_torch.utils.solver import build_optimizer
from test_torch_model import flatten, jax_variables, unflatten
from torch_threads import one_torch_thread  # noqa: F401

# ------------------------------------------------------------------ loss


def loss_inputs(case):
    """preds at the coarse and two flow scales of a 64×128 input, GT with
    zeros, and (case "empty_member") a batch member with no valid pixel or
    (case "all_empty") none at all."""
    rng = np.random.RandomState(0)
    b = 3
    cams = np.zeros((b, 3, 2, 4, 4), np.float32)
    cams[:, :, 1, 3, :2] = [425.0, 2.5]
    cams[1, :, 1, 3, 1] = 1.9
    gt = 425.0 + 40.0 * rng.rand(b, 64, 128, 1).astype(np.float32)
    gt[rng.rand(b, 64, 128, 1) < 0.2] = 0.0
    if case == "empty_member":
        gt[2] = 0.0
    elif case == "all_empty":
        gt[:] = 0.0
    preds = {"coarse_depth_map": 425.0 + 40.0 * rng.rand(b, 8, 16)}
    for i, (h, w) in enumerate([(16, 32), (32, 64)], 1):
        preds[f"flow{i}_input"] = 425.0 + 40.0 * rng.rand(b, h, w)
        preds[f"flow{i}"] = preds[f"flow{i}_input"] + rng.randn(b, h, w) * 3
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    return preds, gt, cams


@pytest.mark.parametrize("case", ["empty_member", "all_empty"])
@pytest.mark.parametrize("threshold", [0.0, 2.0])
def test_loss_and_metrics(case, threshold):
    preds, gt, cams = loss_inputs(case)
    jp = {k: jnp.asarray(v) for k, v in preds.items()}
    tp = {k: torch.from_numpy(v) for k, v in preds.items()}
    want = jloss(jp, jnp.asarray(gt), jnp.asarray(cams), valid_threshold=threshold)
    got = pointmvsnet_loss(tp, torch.from_numpy(gt), torch.from_numpy(cams),
                           valid_threshold=threshold)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.isfinite(float(got[k]))
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    if case == "empty_member":
        assert float(want["total_loss"]) > 0
    want = jmetrics(jp, jnp.asarray(gt), jnp.asarray(cams))
    got = pointmvsnet_metrics(tp, torch.from_numpy(gt), torch.from_numpy(cams))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


def test_gt_resize_is_nearest_exact():
    """The port's GT resize equals jax.image.resize(method="nearest")."""
    from pointmvsnet_tpu_torch.models.loss import _resize_gt
    gt = np.random.RandomState(1).rand(2, 512, 640).astype(np.float32)
    for h, w in [(64, 80), (128, 160), (256, 320), (37, 53)]:
        want = jax.image.resize(jnp.asarray(gt), (2, h, w), method="nearest")
        np.testing.assert_array_equal(_resize_gt(torch.from_numpy(gt), h, w).numpy(),
                                      np.asarray(want))


# ------------------------------------------------------------------ optimizer

@pytest.mark.parametrize("kind", ["RMSprop", "Adam", "SGD"])
def test_optimizer_matches_optax(kind):
    """4 steps, the second with a NaN gradient (skipped), weight decay, a
    StepLR boundary at every step, and a frozen module."""
    rng = np.random.RandomState(2)
    shapes = {"img_conv.w": (3, 4), "vol_conv.b": (5,), "point_flow.k": (2, 3)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(4)]
    grads[1]["vol_conv.b"][2] = np.nan

    def configure(cfg):
        cfg.SOLVER.TYPE = kind
        cfg.SCHEDULER.STEP_LR.STEP_SIZE = 1
        cfg.TRAIN.FROZEN_PATTERNS = ("point_flow",)
        return cfg

    def nest(flat):
        out = {}
        for k, v in flat.items():
            mod, leaf = k.split(".")
            out.setdefault(mod, {})[leaf] = jnp.asarray(v)
        return out

    jopt = jbuild_optimizer(configure(jget_default_cfg()), steps_per_epoch=1)
    jparams = nest(init)
    jstate = jopt.init(jparams)
    params = {k: torch.tensor(v) for k, v in init.items()}
    opt = build_optimizer(configure(get_default_cfg()), params, steps_per_epoch=1)
    assert opt.frozen == {"point_flow.k"}
    for i, g in enumerate(grads):
        updates, jstate = jopt.update(nest(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        applied = opt.step({k: torch.from_numpy(v) for k, v in g.items()})
        assert applied == (i != 1)
        total, consec = int(jstate.total_notfinite), int(jstate.notfinite_count)
        assert (opt.skipped_steps, opt.consecutive_skipped) == (total, consec)
        for k in shapes:
            mod, leaf = k.split(".")
            np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[mod][leaf]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"step {i} {k}")
    np.testing.assert_array_equal(params["point_flow.k"].numpy(), init["point_flow.k"])
    assert opt.count == 3


def test_optimizer_state_round_trip():
    params = dict(torch.nn.Linear(3, 2).named_parameters())
    opt = build_optimizer(get_default_cfg(), params)
    opt.step({n: torch.ones_like(p) for n, p in params.items()})
    opt2 = build_optimizer(get_default_cfg(), params)
    opt2.load_state_dict(opt.state_dict())
    assert opt2.count == 1
    for n in opt.slots:
        torch.testing.assert_close(opt2.slots[n]["nu"], opt.slots[n]["nu"], rtol=0, atol=0)


# ------------------------------------------------------------------ train-mode modules
# outputs atol 1e-4 (stacked f32 convs / matmuls, batch moments summed in
# another order), running statistics atol 1e-5

def run_train_mode(jm, jargs, tm, prefix_jax, prefix_torch, rng, targs):
    var = jax_variables(jm, rng, *jargs)
    want, mutated = jm.apply(unflatten(var), *jargs, True, mutable=["batch_stats"])
    flat = {k.replace("/", "/" + prefix_jax, 1): v for k, v in var.items()}
    sd = {k.removeprefix(prefix_torch): v for k, v in jax_to_torch(flat).items()}
    tm.load_state_dict(sd, strict=False)
    tm.train()
    with torch.no_grad():
        got = tm(*targs)
    new_stats = {k.replace("/", "/" + prefix_jax, 1): np.asarray(v)
                 for k, v in flatten(mutated).items()}
    stats = {k.removeprefix(prefix_torch): v for k, v in jax_to_torch(new_stats).items()}
    assert stats and all(k.endswith(("running_mean", "running_var")) for k in stats)
    tsd = tm.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(tsd[k].numpy(), v.numpy(), atol=1e-5, rtol=0, err_msg=k)
    return got, want


def test_image_conv_train():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 48, 3).astype(np.float32)
    got, want = run_train_mode(JImageConv(4, "bn"), [jnp.asarray(x)], ImageConv(4, "bn"),
                               "img_conv/", "img_conv.", rng, [torch.from_numpy(x)])
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=0)


def test_volume_conv_train():
    rng = np.random.RandomState(1)
    x = rng.rand(2, 8, 8, 16, 16).astype(np.float32)
    got, want = run_train_mode(JVolumeConv(4, "bn"), [jnp.asarray(x)],
                               VolumeConv(4, 16, "bn"), "vol_conv/", "vol_conv.", rng,
                               [torch.from_numpy(x)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_shared_mlp_train():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 50, 12).astype(np.float32)
    jm = JSharedMLP((16, 8, 1), norm="bn", last_relu=False, last_norm=False)
    tm = SharedMLP(12, (16, 8, 1), "bn", last_relu=False, last_norm=False)
    got, want = run_train_mode(jm, [jnp.asarray(x)], tm, "point_flow/core/SharedMLP_0/",
                               "point_flow.head.", rng, [torch.from_numpy(x)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_edge_conv_train():
    rng = np.random.RandomState(3)
    g, h, w, c = 5, 6, 8, 6
    pts = rng.rand(2, g * h * w, 3).astype(np.float32)
    idx = window_knn(torch.from_numpy(pts), (g, h, w), 16)
    x = rng.randn(2, g * h * w, c).astype(np.float32)
    got, want = run_train_mode(JEdgeConv(8, norm="bn"), [jnp.asarray(x), jnp.asarray(idx.numpy())],
                               EdgeConv(c, 8, "bn"), "point_flow/core/EdgeConv_0/",
                               "point_flow.edge_convs.0.", rng, [torch.from_numpy(x), idx])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("seed,c,f", [(4, 6, 8), (5, 16, 32)])
def test_edge_conv_train_gradients(seed, c, f):
    """Train-mode EdgeConv with autograd on (the port's checkpointed gather
    path) against jax.grad of the flax EdgeConv on a fixed kNN graph: the
    gradients of the kernel, the BN scale and bias and the input within
    1e-4 of their max |g|; outputs atol 1e-4, running statistics atol 1e-5."""
    rng = np.random.RandomState(seed)
    g, h, w = 5, 6, 8
    pts = rng.rand(2, g * h * w, 3).astype(np.float32)
    idx = window_knn(torch.from_numpy(pts), (g, h, w), 16)
    x = rng.randn(2, g * h * w, c).astype(np.float32)
    cot = rng.randn(2, g * h * w, f).astype(np.float32)
    jm = JEdgeConv(f, norm="bn")
    jidx = jnp.asarray(idx.numpy())
    var = unflatten(jax_variables(jm, rng, jnp.asarray(x), jidx))

    def loss(params, xx):
        out, mutated = jm.apply({"params": params, "batch_stats": var["batch_stats"]},
                                xx, jidx, True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mutated)

    (_, (want, mutated)), (gparams, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(var["params"], jnp.asarray(x))

    prefix_jax, prefix_torch = "point_flow/core/EdgeConv_0/", "point_flow.edge_convs.0."

    def to_torch(tree):
        flat = {k.replace("/", "/" + prefix_jax, 1): np.asarray(v)
                for k, v in flatten(tree).items()}
        return {k.removeprefix(prefix_torch): v for k, v in jax_to_torch(flat).items()}

    tm = EdgeConv(c, f, "bn")
    tm.load_state_dict(to_torch({"params": var["params"], "batch_stats": var["batch_stats"]}))
    tm.train()
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt, idx)
    (got * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)
    for k, v in to_torch(mutated).items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), v.numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)
    grads = {**to_torch({"params": gparams}), "x": torch.from_numpy(np.array(gx))}
    assert sorted(grads) == sorted(["kernel", "norm.weight", "norm.bias", "x"])
    for k, want_g in grads.items():
        got_g = xt.grad if k == "x" else tm.get_parameter(k).grad
        bar = 1e-4 * float(want_g.abs().max())
        assert float((got_g - want_g).abs().max()) <= bar, k


# ------------------------------------------------------------------ train()

H, W, D = 64, 128, 16


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dtu"))
    make_synthetic_dtu(root, scans=[2, 3], num_views=3, height=H, width=W, num_depth=D)
    cfg = get_default_cfg()
    for split in ("TRAIN", "VAL"):
        cfg.DATA[split].ROOT_DIR = root
        cfg.DATA[split].NUM_VIEW = 3
    cfg.DATA.TRAIN.NUM_VIRTUAL_PLANE = D
    cfg.DATA.TRAIN.INTERVAL_SCALE = 1.0
    cfg.MODEL.NUM_VIRTUAL_PLANE = D
    cfg.MODEL.IMG_BASE_CHANNELS = 4
    cfg.MODEL.VOL_BASE_CHANNELS = 4
    cfg.MODEL.EDGE_CHANNELS = (8, 8)
    cfg.MODEL.FLOW_CHANNELS = (8, 1)
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.SCHEDULER.MAX_EPOCH = 2
    cfg.SCHEDULER.INIT_EPOCH = 1   # epoch 0 coarse-only, epoch 1 with flow
    return cfg, str(tmp_path_factory.mktemp("out"))


def test_train_two_epochs_with_curriculum(env):
    from pointmvsnet_tpu_torch.train import train
    cfg, out = env
    state = train(cfg, out, max_steps_per_epoch=2, device="cpu")
    assert state.step == 4                       # 2 epochs × 2 steps
    assert state.optimizer.count == 4 and state.optimizer.skipped_steps == 0
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["0.pt", "1.pt"]
    assert os.path.isfile(os.path.join(out, "log.txt"))
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_auto_resume_continues(env):
    from pointmvsnet_tpu_torch.train import train
    cfg, out = env
    cfg2 = cfg.clone()
    cfg2.SCHEDULER.MAX_EPOCH = 3
    state = train(cfg2, out, max_steps_per_epoch=2, device="cpu")
    # resumed after epoch 1: one more epoch of 2 steps on the restored counter
    assert state.step == 6 and state.optimizer.count == 6
    assert "2.pt" in os.listdir(os.path.join(out, "checkpoints"))


@pytest.mark.parametrize("key,value,error", [("MODEL.DTYPE", "float16", KeyError),
                                             ("PARALLEL.DATA", 2, ValueError)])
def test_train_refuses_what_is_not_ported(env, key, value, error):
    """A dtype the port has no model for, and PARALLEL.DATA=2 in a launch
    of one process (bf16 and PARALLEL.DATA = world size train:
    tests/test_torch_bf16_train.py, tests/test_torch_distributed.py)."""
    from pointmvsnet_tpu_torch.train import train
    cfg = env[0].clone()
    cfg.merge_from_list([key, value])
    with pytest.raises(error):
        train(cfg, env[1], device="cpu")


def test_main_cli(env, tmp_path):
    """The command line without --cfg: defaults plus dotted overrides."""
    from pointmvsnet_tpu_torch.train import main
    cfg, _ = env
    out = str(tmp_path / "cli")
    state = main(["--device", "cpu",
                  "DATA.TRAIN.ROOT_DIR", cfg.DATA.TRAIN.ROOT_DIR,
                  "DATA.VAL.ROOT_DIR", cfg.DATA.VAL.ROOT_DIR, "OUTPUT_DIR", out,
                  "DATA.TRAIN.NUM_VIRTUAL_PLANE", str(D), "MODEL.NUM_VIRTUAL_PLANE", str(D),
                  "MODEL.IMG_BASE_CHANNELS", "4", "MODEL.VOL_BASE_CHANNELS", "4",
                  "MODEL.EDGE_CHANNELS", "(8,)", "MODEL.FLOW_CHANNELS", "(8, 1)",
                  "MODEL.TRAIN.IMG_SCALES", "(0.25,)", "MODEL.TRAIN.INTER_SCALES", "(0.75,)",
                  "TRAIN.BATCH_SIZE", "4", "SCHEDULER.INIT_EPOCH", "0",
                  "SCHEDULER.MAX_EPOCH", "1"])
    assert state.step == 21 // 4
    assert os.listdir(os.path.join(out, "checkpoints")) == ["0.pt"]
