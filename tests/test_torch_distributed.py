"""Data parallelism of the PyTorch port: two gloo ranks (spawned processes,
a ``FileStore``, no network) at global B=4 against the port on one rank at
B=4 and against the JAX package's ``make_train_step`` on ``make_mesh(2)``
(sync-BN over the global batch); then train() and the test CLI on two
ranks.

The step runs at a tiny config (64×128, V=3, D=16, base 4, EdgeConv (8,),
head (8, 1), K=8, BatchNorm, one flow at 0.25), coarse-only and with the
flow, in f32 and in bf16, from the same seeded weights on the same noisy
images (σ = 3, as tests/test_torch_train_step.py). Every port run's kNN
gets the JAX step's kNN input points, each rank its rows, and the JAX
step routes the gradient of EdgeConv's max over K to the argmax
(tests/test_torch_train_step.py says why). Gradients are compared before
the update, not parameters after it: RMSprop's first step is about
lr·sign(g) and turns the sign of a near-zero gradient into a whole step.

Bars, two ranks against one (the same arithmetic up to the order of the
sums):
- losses rtol 2e-4, the bar of tests/test_parallel.py for the JAX
  package's own 8-device step;
- f32: BN running statistics rtol 2e-4 (atol 1e-6), the same bar; every
  gradient within 1e-4 of its parameter's max |g| coarse-only and 1e-2
  with the flow (near-tied maxima over K, as in
  tests/test_torch_train_step.py);
- bf16: the other order of the f32 sums (sync-BN's moments, the loss's
  count) moves some f32 values across a bf16 rounding boundary, and bf16
  training amplifies such flips (tests/test_torch_bf16_train.py): the
  statistics within 2⁻⁷ of their largest magnitude, and the gradients
  held to the one-rank f32 gradients on the same kNN graph: their RMS
  relative L2 distance from them at most twice the one-rank bf16
  step's.
Two ranks against the JAX package: in f32 the same bars; in bf16 those of
tests/test_torch_bf16_train.py (losses rtol 2⁻⁸, statistics 2⁻⁷ of their
max, gradients held to the port's one-rank f32 gradients as above, at
most twice as far as the reference's bf16 gradients).
A fault of the data-parallel semantics (per-rank statistics, a mean of
per-rank losses, averaged instead of summed gradients) moves these
quantities by 1e-1 to a factor of 2; the f32 bars catch each of them,
and the bf16 bars catch the first two.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointmvsnet_tpu.models.edge_conv as jedge_conv
import pointmvsnet_tpu.models.pointmvsnet as jpointmvsnet
from pointmvsnet_tpu.config import get_default_cfg as jget_default_cfg
from pointmvsnet_tpu.models import build_model as jbuild_model
from pointmvsnet_tpu.parallel import make_mesh, replicate, shard_batch
from pointmvsnet_tpu.parallel.train_step import TrainState as JTrainState
from pointmvsnet_tpu.parallel.train_step import make_train_step as jmake_train_step
from pointmvsnet_tpu_torch.dataset import io
from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch, make_synthetic_dtu
from pointmvsnet_tpu_torch.utils.convert import jax_to_torch
from test_torch_bf16_train import GRAD_RMS_FACTOR, LOSS_RTOL, STATS_BAR
from test_torch_model import flatten, jax_variables, unflatten
from test_torch_train_step import IMAGE_NOISE, KERNEL_SCALE, ArgmaxRoutedNumpy, keep_grads
from torch_dp_worker import spawn, tiny_cfg, train_cfg, train_step
from torch_threads import one_torch_thread  # noqa: F401

B, V, H, W, D = 4, 3, 64, 128, 16
RTOL, ATOL = 2e-4, 1e-6
F32_GRAD_BAR = {False: 1e-4, True: 1e-2}        # of max |g|, by is_flow
SHIFT_INVARIANT = ("vol_conv.convs.7.conv.bias", "point_flow.head.layers.1.linear.bias")
CONFIGS = [("float32", False), ("float32", True), ("bfloat16", False), ("bfloat16", True)]


def jax_cfg(dtype):
    cfg = jget_default_cfg()
    src = tiny_cfg(dtype)
    for key in ("IMG_BASE_CHANNELS", "VOL_BASE_CHANNELS", "EDGE_CHANNELS", "FLOW_CHANNELS",
                "KNN", "NUM_VIRTUAL_PLANE", "MASKED_LOSS", "NORM", "DTYPE"):
        cfg.MODEL[key] = src.MODEL[key]
    return cfg


def model_kw(is_flow):
    return dict(is_flow=is_flow, img_scales=(0.25,), inter_scales=(0.75,), num_virtual_plane=D)


@pytest.fixture(scope="module")
def batch():
    images, cams, gt = make_scene_batch(B, V, H, W, D, seed=5)
    images = images + IMAGE_NOISE * np.random.RandomState(7).randn(*images.shape)
    jm, _, _ = jbuild_model(jax_cfg("float32"))
    flat = jax_variables(jm, np.random.RandomState(6), jnp.asarray(images[:2, :, :64, :64]),
                         jnp.asarray(cams[:2]), **dict(model_kw(True), num_virtual_plane=8),
                         kernel_scale=KERNEL_SCALE)
    return {"images": images.astype(np.float32), "cams": cams, "gt_depth": gt[..., None]}, flat


def run_jax_mesh2(dtype, kw, batch, flat):
    """The JAX package's step on ``make_mesh(2)`` → (result, kNN input points)."""
    jm, jloss, _ = jbuild_model(jax_cfg(dtype))
    variables = unflatten(flat)
    mesh = make_mesh(2)
    state = replicate(JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  opt_state=keep_grads().init(variables["params"])), mesh)
    points = []
    jknn = jpointmvsnet.window_knn_auto

    def recording_knn(pts, *args, **kwargs):
        jax.debug.callback(lambda p: points.append(np.array(p)), pts)
        return jknn(pts, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpointmvsnet, "window_knn_auto", recording_knn)
        mp.setattr(jedge_conv, "jnp", ArgmaxRoutedNumpy())
        step = jmake_train_step(jm, jloss, keep_grads(), mesh, kw)
        new, losses = step(state, shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh))
        jax.effects_barrier()
    return dict(losses={k: float(v) for k, v in losses.items()},
                grads=jax_to_torch({f"params/{k.removeprefix('g/')}": np.asarray(v)
                                    for k, v in flatten({"g": new.opt_state}).items()}),
                stats=jax_to_torch(flatten({"batch_stats": new.batch_stats}))), \
        (points[0] if points else None)


@pytest.fixture(scope="module", params=CONFIGS, ids=[f"{d}-{'flow' if f else 'coarse'}"
                                                     for d, f in CONFIGS])
def steps(request, batch, tmp_path_factory):
    """→ config, {"jax", "one", "two": [rank 0, rank 1], "f32": the one-rank
    f32 step on the same kNN graph (bf16 only)}."""
    dtype, is_flow = request.param
    data, flat = batch
    kw = model_kw(is_flow)
    want, points = run_jax_mesh2(dtype, kw, data, flat)
    assert (points is not None) == is_flow
    out = {"jax": want, "one": train_step(dtype, kw, flat, data, points)}
    if dtype == "bfloat16":
        out["f32"] = train_step("float32", kw, flat, data, points)
    job = dict(kind="step", dtype=dtype, kw=kw, flat=flat, batch=data, knn_points=points)
    out["two"] = [r[0] for r in spawn([job], str(tmp_path_factory.mktemp("dp_step")))]
    return request.param, out


def test_two_ranks_agree(steps):
    """Both ranks return the same global losses and BN statistics and the
    same (all-reduced) gradients, and applied the update."""
    _, out = steps
    r0, r1 = out["two"]
    assert r0["losses"] == r1["losses"] and r0["applied"] == r1["applied"] == 1
    for key in ("grads", "stats"):
        for name, v in r0[key].items():
            assert torch.equal(v, r1[key][name]), name


def check_losses_and_stats(got, want, rtol, stats_bar=None):
    """Losses within ``rtol``; BN statistics within ``rtol`` (atol 1e-6),
    or within ``stats_bar`` of each statistic's largest magnitude."""
    for k, v in want["losses"].items():
        assert np.isfinite(got["losses"][k]), k
        np.testing.assert_allclose(got["losses"][k], v, rtol=rtol, err_msg=k)
    assert sorted(got["stats"]) == sorted(want["stats"]) and want["stats"]
    for name, v in want["stats"].items():
        if stats_bar is None:
            np.testing.assert_allclose(got["stats"][name].numpy(), v.numpy(), rtol=rtol,
                                       atol=ATOL, err_msg=name)
        else:
            assert float((got["stats"][name] - v).abs().max()) <= stats_bar * float(v.abs().max())


def check_grads_max(got, want, bar):
    """Each gradient within ``bar`` of its parameter's max |g|."""
    largest = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        tg = got[name]
        if name in SHIFT_INVARIANT:
            assert max(float(g.abs().max()), float(tg.abs().max())) < 1e-5 * largest, name
            continue
        diff = float((tg - g).abs().max())
        assert diff <= bar * float(g.abs().max()), f"{name}: max |Δg| {diff:.3e}"


def rms_distance(grads, ref):
    """RMS over the parameters of ‖g − ref‖ / ‖ref‖ (the two softmax-shifted
    biases and the parameters no output uses left out)."""
    d = [float((grads[n] - g32).norm()) / float(g32.norm()) for n, g32 in ref.items()
         if n not in SHIFT_INVARIANT and float(g32.norm()) > 0]
    return float(np.sqrt(np.mean(np.square(d))))


def test_two_ranks_match_one_rank(steps):
    (dtype, is_flow), out = steps
    got, want = out["two"][0], out["one"]
    if dtype == "float32":
        check_losses_and_stats(got, want, RTOL)
        check_grads_max(got["grads"], want["grads"], F32_GRAD_BAR[is_flow])
        return
    check_losses_and_stats(got, want, RTOL, stats_bar=STATS_BAR)
    two, one = rms_distance(got["grads"], out["f32"]["grads"]), \
        rms_distance(want["grads"], out["f32"]["grads"])
    assert two <= GRAD_RMS_FACTOR * one, (two, one)


def test_two_ranks_match_jax_mesh2(steps):
    (dtype, is_flow), out = steps
    got, want = out["two"][0], out["jax"]
    assert sorted(want["losses"]) == sorted(k for k in got["losses"]
                                            if k not in ("skipped_steps", "consecutive_skipped"))
    if dtype == "float32":
        check_losses_and_stats(got, want, RTOL)
        check_grads_max(got["grads"], want["grads"], F32_GRAD_BAR[is_flow])
        return
    check_losses_and_stats(got, want, LOSS_RTOL, stats_bar=STATS_BAR)
    two, ref = rms_distance(got["grads"], out["f32"]["grads"]), \
        rms_distance(want["grads"], out["f32"]["grads"])
    assert two <= GRAD_RMS_FACTOR * ref, (two, ref)


# ------------------------------------------------------------ train() and the test CLI

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """train() (2 coarse-only steps of global B=4, then a resume by one
    more epoch) and the test CLI on two ranks; the same on one rank."""
    from pointmvsnet_tpu_torch import test as test_cli
    from pointmvsnet_tpu_torch.train import train

    root = str(tmp_path_factory.mktemp("dtu"))
    make_synthetic_dtu(root, scans=[1, 2, 3], num_views=V, height=H, width=W, num_depth=D)
    opts = ["DATA.TRAIN.ROOT_DIR", root, "DATA.VAL.ROOT_DIR", root, "DATA.TRAIN.NUM_VIEW", V,
            "DATA.VAL.NUM_VIEW", V, "DATA.TRAIN.NUM_VIRTUAL_PLANE", D,
            "DATA.TRAIN.INTERVAL_SCALE", 1.0, "TRAIN.BATCH_SIZE", B,
            "SCHEDULER.INIT_EPOCH", 5, "SCHEDULER.MAX_EPOCH", 1]
    work = tmp_path_factory.mktemp("dp_cli")
    export_opts = ["DATA.TEST.ROOT_DIR", root, "DATA.TEST.NUM_VIEW", str(V),
                   "DATA.TEST.NUM_VIRTUAL_PLANE", str(D), "DATA.TEST.IMG_HEIGHT", str(H),
                   "DATA.TEST.IMG_WIDTH", str(W), "DATA.TEST.INTERVAL_SCALE", "1.0",
                   "MODEL.TEST.IMG_SCALES", "(0.25,)", "MODEL.TEST.INTER_SCALES", "(0.75,)",
                   "MODEL.IMG_BASE_CHANNELS", "4", "MODEL.VOL_BASE_CHANNELS", "4",
                   "MODEL.EDGE_CHANNELS", "(8,)", "MODEL.FLOW_CHANNELS", "(8, 1)"]
    jobs = [dict(kind="train", opts=opts, out=str(work / "two"), steps=2),
            dict(kind="train", opts=opts + ["SCHEDULER.MAX_EPOCH", 2], out=str(work / "two"),
                 steps=1),
            dict(kind="export", opts=export_opts + ["OUTPUT_DIR", str(work / "export_two")]),
            dict(kind="raises", opts=opts + ["TRAIN.BATCH_SIZE", 3], out=str(work / "bad")),
            dict(kind="raises", opts=opts + ["PARALLEL.DATA", 3], out=str(work / "bad"))]
    two = spawn(jobs, str(work / "ranks"))
    one = {"train": train(train_cfg(opts), str(work / "one"), max_steps_per_epoch=2,
                          device="cpu"),
           "export": {}}
    for batch_size in ("1", "2"):
        one["export"][batch_size] = test_cli.main(
            ["--device", "cpu", "TEST.BATCH_SIZE", batch_size,
             "OUTPUT_DIR", str(work / f"export_one_{batch_size}")] + export_opts)
    return two, one, work


def test_train_on_two_ranks(cli_runs):
    """train() with PARALLEL.DATA -1 on two ranks: both ranks end with the
    same parameters and BN statistics, rank 0 alone wrote the log and the
    checkpoints, and the resume read them on both ranks; the parameters
    after two steps are within the largest gap two RMSprop steps can open
    (each moves a parameter by at most lr·√10) of the one-rank run's."""
    two, one, work = cli_runs
    (t0, r0), (t1, r1) = two[0][:2], two[1][:2]
    assert t0["step"] == t1["step"] == 2 and r0["step"] == r1["step"] == 3
    assert t0["skipped"] == r0["skipped"] == 0
    for key in ("params", "buffers"):
        for name, v in r0[key].items():
            assert torch.equal(v, r1[key][name]), name
    ckpts = sorted(os.listdir(work / "two" / "checkpoints"))
    assert ckpts == ["0.pt", "1.pt"]
    assert os.path.isfile(work / "two" / "log.txt")
    lr = tiny_cfg("float32").SOLVER.BASE_LR
    for name, p in one["train"].model.named_parameters():
        gap = float((t0["params"][name] - p.detach()).abs().max())
        assert gap <= 4 * lr * 10 ** 0.5 + 1e-6, name


def test_train_refuses_a_batch_the_ranks_cannot_split(cli_runs):
    two, _, _ = cli_runs
    for rank in two:
        bad_batch, bad_data = rank[3], rank[4]
        assert bad_batch.startswith("ValueError") and "batch of 3" in bad_batch
        assert bad_data.startswith("ValueError") and "PARALLEL.DATA=3" in bad_data


def test_export_on_two_ranks_equals_one_rank(cli_runs):
    """Each rank exports its own items into the one depth directory; their
    union equals the one-rank export item by item, bit for bit, and the
    one-rank export at TEST.BATCH_SIZE 2 equals it within rtol 1e-6 (the
    CPU's batched convs sum in another order: a few ulps); the summaries
    cover every item."""
    two, one, _ = cli_runs
    dirs = [two[0][2]["depth_dir"], one["export"]["1"][1], one["export"]["2"][1]]
    assert two[1][2]["depth_dir"] == dirs[0]
    listings = [sorted(os.listdir(os.path.join(d, "scan1"))) for d in dirs]
    assert listings[0] == listings[1] == listings[2] and len(listings[0]) == V * 5
    for name in listings[0]:
        if not name.endswith(".pfm"):
            continue
        maps = [io.load_pfm(os.path.join(d, "scan1", name)) for d in dirs]
        np.testing.assert_array_equal(maps[0], maps[1], err_msg=name)
        np.testing.assert_allclose(maps[2], maps[1], rtol=1e-6, atol=1e-6, err_msg=name)
    s2, s1 = two[0][2]["summary"], one["export"]["1"][0]
    assert s2["maps"] == s1["maps"] == V and two[1][2]["summary"]["maps"] == V
    for k in s1:
        if k not in ("maps", "maps_per_s", "maps_per_s_after_first"):
            np.testing.assert_allclose(s2[k], s1[k], rtol=1e-6, err_msg=k)


# ------------------------------------------------------------ the pieces, in one process

def test_loader_ranks_split_every_global_batch():
    """Rank r of W keeps rows [r·b/W, (r+1)·b/W) of each shuffled global
    batch: W ranks see the one-rank loader's batches; a batch the ranks
    cannot split raises."""
    from pointmvsnet_tpu_torch.dataset.build import DataLoader, RankShard

    data = [{"i": np.array(i)} for i in range(23)]
    one = DataLoader(data, 4, shuffle=True, seed=3)
    ranks = [DataLoader(data, 4, shuffle=True, seed=3, rank=r, world=2) for r in range(2)]
    for epoch in (0, 1):
        for loader in (one, *ranks):
            loader.set_epoch(epoch)
        want = [b["i"] for b in one]
        got = [np.concatenate([a["i"], b["i"]]) for a, b in zip(*ranks)]
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="batch of 3"):
        DataLoader(data, 3, rank=0, world=2)
    shards = [[int(x["i"]) for x in RankShard(data, r, 3)] for r in range(3)]
    assert sorted(sum(shards, [])) == list(range(23)) and shards[1][:2] == [1, 4]


def test_cuda_is_the_local_rank_card(monkeypatch):
    from pointmvsnet_tpu_torch import resolve_device

    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert resolve_device("cuda") == torch.device("cuda", 1) and current == [torch.device("cuda", 1)]
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    assert resolve_device("cuda") == torch.device("cuda")
