"""Banded PointFlow, band- and view-parallel eval on a data × band × view
grid of ranks, and the per-stage profiler of the PyTorch port, against the
JAX package on its 8 forced CPU devices (tests/conftest.py).

The port's ranks are spawned once for the module: eight gloo ranks
(tests/torch_grid_worker.py, a FileStore, one torch thread each) run every
grid's jobs, each job on the grid it names over all eight ranks. The
models are tests/test_parallel.py's tiny one (64×64, V=2, D=8, base 4,
EdgeConv (8,), head (8, 1), K=8), from the same numpy weights in both
packages (kernels ×2, BN not an identity; tests/test_torch_model.py's
``jax_variables``).

- ``regular_grid_sample`` and ``hypothesis_points`` with a row offset: the
  JAX functions, 1e-6.
- Banded against unbanded in the port under eval BatchNorm: bit-equal (the
  halo covers the three EdgeConvs' reach, tests/test_model.py's claim for
  the JAX package).
- The port banded at FLOW_CHUNK_ROWS 8 against the JAX package banded at 8,
  BN and GN: tests/test_torch_model.py's bars (max |Δ| < 0.05, mean <
  0.005); GN's per-band statistics make both differ from unbanded.
- ``view_sharded_plane_sweep`` on 2 and 4 ranks, 1 to 4 views each,
  against the JAX function on a 4-device mesh: atol 2e-5
  (tests/test_view_parallel.py).
- Band-parallel flow on band groups of 2 and 4 ranks (flow1: 4 bands of 8
  rows; flow2: 5 bands, uneven on both, as the JAX package shards them):
  bit-equal to the port's serial banded forward; and, with the kNN fed the
  JAX package's kNN input points (``fed_knn``: near-ties flip under f32
  differences of ~1e-6 and move a depth by up to 1e-2), rtol / atol 1e-5
  against the JAX band mesh (tests/test_parallel.py's bar).
- A 2×2×2 grid through ``make_eval_step``, the setup of the JAX package's
  ``test_combined_data_band_view_mesh`` (BN, FLOW_CHUNK_ROWS 16, B=2, flow
  at 1.0), kNN fed as above: predictions rtol / atol 1e-4 against the JAX
  package's eval step on ``make_mesh_eval(2, 2, 2)`` (that test's bar),
  losses rtol 1e-4.
- The test CLI with PARALLEL.BAND 2 (band groups of 2 ranks, 4 data
  indices) and with BAND 2 × VIEW 2: equal PFMs and ``maps`` count to the
  one-rank export; bit-equal for bands alone, 1e-4 with the view-parallel
  cost volume (its sum of moments runs in another order).
- ``stage_latencies`` / ``train_stage_latencies`` return the JAX package's
  keys; ``trace`` writes a Chrome trace.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import pointmvsnet_tpu.models.pointmvsnet as jpointmvsnet
from pointmvsnet_tpu.models import build_model as jbuild_model
from pointmvsnet_tpu.ops.sampling import regular_grid_sample as jregular_grid_sample
from pointmvsnet_tpu.parallel import make_mesh_2d, make_mesh_eval, replicate, shard_batch
from pointmvsnet_tpu.parallel.train_step import TrainState as JTrainState
from pointmvsnet_tpu.parallel.train_step import make_eval_step as jmake_eval_step
from pointmvsnet_tpu.parallel.view_parallel import (
    view_sharded_plane_sweep as jview_sharded_plane_sweep,
)
from pointmvsnet_tpu_torch import test as test_cli
from pointmvsnet_tpu_torch.dataset import io
from pointmvsnet_tpu_torch.dataset.synthetic import make_scene_batch, make_synthetic_dtu
from pointmvsnet_tpu_torch.models import build_loss_fn, build_model
from pointmvsnet_tpu_torch.models.pointmvsnet import hypothesis_points
from pointmvsnet_tpu_torch.ops.sampling import regular_grid_sample
from pointmvsnet_tpu_torch.parallel import TrainState, distributed
from pointmvsnet_tpu_torch.utils.convert import init_params
from pointmvsnet_tpu_torch.utils.profiler import stage_latencies, trace, train_stage_latencies
from pointmvsnet_tpu_torch.utils.solver import build_optimizer
from test_parallel import KW, make_batch
from test_parallel import tiny_cfg as jtiny_cfg
from test_torch_model import jax_variables, unflatten
from test_view_parallel import make_scene
from torch_grid_worker import finish, forward, grid_cfg, predict, start
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 8
KERNEL_SCALE = 2.0
# flow1 at 32×32: 4 bands of 8 rows; flow2 at 40×40: 5 bands
BAND_KW = dict(KW, img_scales=(0.5, 0.625), inter_scales=(0.75, 0.375))
COMBINED_KW = dict(KW, img_scales=(1.0,), inter_scales=(0.75,))
SWEEPS = [(n, v) for n in (2, 4) for v in (4, 8)]       # (view ranks, views)
CLI_RUNS = {"band": ["PARALLEL.BAND", "2"],
            "band_view": ["PARALLEL.BAND", "2", "PARALLEL.VIEW", "2"]}
LAYOUTS = [(2, 2, 2), (4, 2, 1), (2, 1, 4), (1, 8, 1), (8, 1, 1), (-1, 2, 2)]


def jax_cfg(norm, chunk_rows):
    cfg = jtiny_cfg()
    cfg.MODEL.NORM = norm
    cfg.MODEL.FLOW_CHUNK_ROWS = chunk_rows
    return cfg


def jax_model(cfg, batch, mesh, view=False):
    """The JAX package's model (``mesh`` its band mesh, and with ``view``
    its view mesh too) and numpy weights for it → (model, loss_fn,
    metric_fn, flat weights). The weights' shapes come from the unbanded
    serial model at one small flow: they depend on the widths alone."""
    model, loss_fn, metric_fn = jbuild_model(cfg, band_mesh=mesh,
                                             view_mesh=mesh if view else None)
    shapes, _, _ = jbuild_model(jax_cfg(cfg.MODEL.NORM, 0))
    flat = jax_variables(shapes, np.random.RandomState(3), jnp.asarray(batch["images"][:1]),
                         jnp.asarray(batch["cams"][:1]), kernel_scale=KERNEL_SCALE,
                         **dict(KW, img_scales=(0.25,)))
    return model, loss_fn, metric_fn, flat


def run_jax(built, batch, kw, mesh=None, view=False):
    """The JAX package's eval forward, its kNN input points recorded →
    (preds, losses, points). With ``view`` it runs through
    ``make_eval_step`` on the mesh, as test_combined_data_band_view_mesh."""
    model, loss_fn, metric_fn, flat = built
    variables = unflatten(flat)
    points = []
    knn = jpointmvsnet.window_knn_mask_auto

    def recording(pts, *args, **kwargs):
        jax.debug.callback(lambda p: points.append(np.array(p)), pts)
        return knn(pts, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpointmvsnet, "window_knn_mask_auto", recording)
        if view:
            state = replicate(JTrainState(step=jnp.zeros((), jnp.int32),
                                          params=variables["params"],
                                          batch_stats=variables["batch_stats"],
                                          opt_state=None), mesh)
            step = jmake_eval_step(model, loss_fn, metric_fn, mesh, kw)
            preds, losses, _ = step(state, shard_batch(
                {k: jnp.asarray(v) for k, v in batch.items()}, mesh))
        else:
            preds = jax.jit(lambda v, im, cm: model.apply(v, im, cm, **kw))(
                variables, jnp.asarray(batch["images"]), jnp.asarray(batch["cams"]))
            losses = {}
        preds = {k: np.asarray(v) for k, v in preds.items()}
        jax.effects_barrier()
    return preds, {k: float(v) for k, v in losses.items()}, points


@pytest.fixture(scope="module")
def band_batch():
    return {k: np.asarray(v[:1]) for k, v in make_batch(np.random.RandomState(0)).items()}


@pytest.fixture(scope="module")
def runs(band_batch, tmp_path_factory):
    """One start of eight ranks, and meanwhile the JAX runs (whose kNN
    input points the ranks' fed jobs wait for) and the port's runs in this
    process."""
    bb = band_batch
    work = tmp_path_factory.mktemp("grid")
    mesh2 = make_mesh_2d(data=1, band=2)
    band = jax_model(jax_cfg("bn", 8), bb, mesh2)
    combined_batch = {k: np.asarray(v[:2])
                      for k, v in make_batch(np.random.RandomState(1)).items()}
    mesh222 = make_mesh_eval(data=2, band=2, view=2)
    combined = jax_model(jax_cfg("bn", 16), combined_batch, mesh222, view=True)
    scenes = {v: [np.asarray(a) for a in make_scene(np.random.RandomState(v), v=v)]
              for v in (4, 6, 8)}

    root = str(tmp_path_factory.mktemp("dtu"))
    make_synthetic_dtu(root, scans=[1], num_views=4, height=64, width=128, num_depth=16,
                       layout="eval")
    cli_opts = ["DATA.TEST.ROOT_DIR", root, "DATA.TEST.NUM_VIEW", "4",
                "DATA.TEST.NUM_VIRTUAL_PLANE", "16", "DATA.TEST.IMG_HEIGHT", "64",
                "DATA.TEST.IMG_WIDTH", "128", "DATA.TEST.INTERVAL_SCALE", "1.0",
                "MODEL.TEST.IMG_SCALES", "(0.25, 0.5)", "MODEL.TEST.INTER_SCALES",
                "(0.75, 0.375)", "MODEL.FLOW_CHUNK_ROWS", "8", "MODEL.IMG_BASE_CHANNELS", "4",
                "MODEL.VOL_BASE_CHANNELS", "4", "MODEL.EDGE_CHANNELS", "(8,)",
                "MODEL.FLOW_CHANNELS", "(8, 1)"]
    pool_file = str(work / "jax_points.pt")
    data = dict(images=bb["images"], cams=bb["cams"], flat=band[3], kw=BAND_KW, cfg=("bn", 8))
    jobs = [dict(kind="layout", shapes=LAYOUTS)]
    jobs += [dict(kind="sweep", grid=(WORLD // n, 1, n), feats=scenes[v][0], cams=scenes[v][1],
                  depths=scenes[v][2]) for n, v in SWEEPS]
    jobs.append(dict(kind="raises", job=dict(jobs[-1], feats=scenes[6][0], cams=scenes[6][1])))
    jobs += [dict(kind="forward", grid=(WORLD // n, n, 1), **data) for n in (2, 4)]
    jobs.append(dict(kind="predict", grid=(4, 2, 1), images=bb["images"][0], cams=bb["cams"][0]))
    jobs += [dict(kind="export", opts=cli_opts + extra + ["OUTPUT_DIR", str(work / name)])
             for name, extra in CLI_RUNS.items()]
    jobs.append(dict(kind="raises", job=dict(kind="layout", shapes=[(3, 2, 1)])))
    jobs += [dict(kind="forward", grid=(WORLD // n, n, 1), pool_file=pool_file,
                  pool_key="band", **data) for n in (2, 4)]
    jobs.append(dict(kind="eval_step", grid=(2, 2, 2), cfg=("bn", 16), flat=combined[3],
                     kw=COMBINED_KW, pool_file=pool_file, pool_key="combined",
                     batch=combined_batch))
    ctx = start(jobs, str(work / "ranks"), WORLD)
    try:
        jax_band = run_jax(band, bb, BAND_KW, mesh2)
        jax_combined = run_jax(combined, combined_batch, COMBINED_KW, mesh222, view=True)
        torch.save({"band": jax_band[2], "combined": jax_combined[2]}, pool_file + ".tmp")
        os.replace(pool_file + ".tmp", pool_file)

        mesh4 = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("view",))
        sweep = jax.jit(lambda f, c, d: jview_sharded_plane_sweep(f, c, c[:, 0], d, mesh4))
        jax_sweeps = {v: np.asarray(sweep(*scenes[v])) for v in (4, 8)}
        gn = jax_model(jax_cfg("gn", 8), bb, mesh2)
        jax_gn = run_jax(gn, bb, BAND_KW, mesh2)
        port = {name: forward(grid_cfg(norm, cr), flat, bb["images"], bb["cams"], BAND_KW,
                              pool=pool)
                for name, norm, cr, flat, pool in [
                    ("bn", "bn", 8, band[3], None), ("bn_fed", "bn", 8, band[3], jax_band[2]),
                    ("gn", "gn", 8, gn[3], None), ("gn_unbanded", "gn", 0, gn[3], None)]}
        port["predictor"] = predict(bb["images"][0], bb["cams"][0])
        one_rank = test_cli.main(["--device", "cpu"] + cli_opts
                                 + ["OUTPUT_DIR", str(work / "one_rank")])
    except BaseException:
        for proc in ctx.processes:
            proc.terminate()
        raise
    ranks = finish(ctx, str(work / "ranks"))
    return dict(jax_band=jax_band, jax_combined=jax_combined, jax_sweeps=jax_sweeps,
                jax_gn=jax_gn, port=port, ranks=ranks, one_rank=one_rank, jobs=jobs)


def rank_results(runs, kind):
    """[(job, [result of rank 0, ..., rank 7])] of the jobs of ``kind``."""
    idx = [i for i, j in enumerate(runs["jobs"]) if j["kind"] == kind]
    return [(runs["jobs"][i], [r[i] for r in runs["ranks"]]) for i in idx]


# ------------------------------------------------------------ the pieces, in one process

@pytest.mark.parametrize("y_offset", [0, 3, 10])
def test_regular_grid_sample_y_offset(y_offset):
    feat = np.random.RandomState(y_offset).randn(2, 12, 20, 4).astype(np.float32)
    args = (20 / 40, 12 / 24, 8, 40, y_offset)
    want = np.asarray(jregular_grid_sample(jnp.asarray(feat), *args))
    got = regular_grid_sample(torch.from_numpy(feat), *args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("y_offset", [0, 4, 24])
def test_hypothesis_points_y_offset(y_offset):
    _, cams, gt = make_scene_batch(1, 2, 48, 40, 16, seed=2)
    depth = gt[:, y_offset:y_offset + 16].astype(np.float32)
    step = np.full((1,), 0.75, np.float32)
    ref = cams[:, 0].copy()
    want = jpointmvsnet.hypothesis_points(jnp.asarray(depth), jnp.asarray(step), 2,
                                          jnp.asarray(ref), y_offset)
    got = hypothesis_points(torch.from_numpy(depth), torch.from_numpy(step), 2,
                            torch.from_numpy(ref), y_offset)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("chunk_rows", [8, 16])
def test_banded_equals_unbanded(chunk_rows):
    """At 64×128, flows at 0.25 / 0.5 / 1.0: FLOW_CHUNK_ROWS 8 bands flow2
    (4 bands) and flow3 (8), 16 only flow3 (4); eval BN, bit for bit. Seeded
    weights, kernels ×2 so that every flow moves the depth."""
    images, cams, _ = make_scene_batch(1, 3, 64, 128, 16, seed=4)
    kw = dict(img_scales=(0.25, 0.5, 1.0), inter_scales=(0.75, 0.375, 0.1875),
              num_virtual_plane=16)
    sd = init_params(build_model(grid_cfg("bn", 0), "cpu"), torch.Generator().manual_seed(0))
    sd = {k: v * KERNEL_SCALE if k.endswith(("kernel", "conv.weight", "linear.weight")) else v
          for k, v in sd.items()}
    out = {}
    for cr in (0, chunk_rows):
        model = build_model(grid_cfg("bn", cr), "cpu")
        model.load_state_dict(sd)
        with torch.inference_mode():
            out[cr] = model(torch.tensor(images), torch.tensor(cams), **kw)
    for key in ("coarse_depth_map", "flow1", "flow2", "flow3"):
        assert torch.equal(out[chunk_rows][key], out[0][key]), key
    for key in ("flow1", "flow2", "flow3"):
        assert (out[0][key] - out[0][f"{key}_input"]).abs().max() > 1e-3, key


@pytest.mark.parametrize("norm", ["bn", "gn"])
def test_banded_matches_jax(norm, runs):
    """FLOW_CHUNK_ROWS 8 in both packages; the JAX package runs on its band
    mesh (2 wide), which equals its serial banded forward and compiles one
    band instead of nine. Under GN the bands move the depth (the port's
    unbanded run differs)."""
    want = runs["jax_band" if norm == "bn" else "jax_gn"][0]
    got = runs["port"][norm]
    if norm == "gn":
        assert not np.array_equal(runs["port"]["gn_unbanded"]["flow2"], got["flow2"])
    for key in ("coarse_depth_map", "flow1", "flow2"):
        diff = np.abs(got[key] - want[key])
        assert diff.max() < 0.05 and diff.mean() < 0.005, (key, diff.max(), diff.mean())


def test_build_model_takes_band_heights():
    for cr in (-1, 0, 8, 64):
        assert build_model(grid_cfg("bn", cr), "cpu").flow_chunk_rows == cr
    for cr in (-2, "64", 8.0):
        with pytest.raises(ValueError, match="FLOW_CHUNK_ROWS"):
            build_model(grid_cfg("bn", cr), "cpu")


def test_make_eval_grid_checks_sizes(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "8")
    with pytest.raises(ValueError, match="PARALLEL.DATA=3"):
        distributed.make_eval_grid(3, 2, 1, device="cpu")
    with pytest.raises(ValueError, match="multiple of 3"):
        distributed.make_eval_grid(-1, 3, 1, device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    assert distributed.make_eval_grid(-1, 1, 1, device="cpu") == distributed.EvalGrid()


# ------------------------------------------------------------ on the eight ranks

def test_grid_layout(runs):
    """Rank (d·band + b)·view + v, as np.arange(world).reshape(data, band,
    view); every group the ranks of its axis; no group on size-1 axes."""
    (_, results), = rank_results(runs, "layout")
    for shape in LAYOUTS:
        d = shape[0] if shape[0] > 0 else WORLD // (shape[1] * shape[2])
        at = np.arange(WORLD).reshape(d, shape[1], shape[2])
        for r, res in enumerate(results):
            index, lead, groups = res[shape]
            assert at[index] == r and lead == (index[1:] == (0, 0))
            want = {"band_group": at[index[0], :, index[2]].tolist(),
                    "view_group": at[index[0], index[1], :].tolist(),
                    "data_group": at[:, index[1], index[2]].tolist()}
            for name, ranks in want.items():
                axis_used = {"band_group": shape[1] > 1, "view_group": shape[2] > 1,
                             "data_group": shape[1] * shape[2] > 1}[name]
                assert groups[name] == (ranks if axis_used else None), (shape, r, name)


def test_grid_refuses_a_data_axis_the_launch_does_not_have(runs):
    job, results = rank_results(runs, "raises")[-1]
    assert all(r.startswith("ValueError") and "PARALLEL.DATA=3" in r for r in results)


@pytest.mark.parametrize("n_view,n_views", SWEEPS)
def test_view_sharded_plane_sweep(runs, n_view, n_views):
    """Every rank returns the whole cost volume, within 2e-5 of the JAX
    function on a 4-device mesh."""
    for job, results in rank_results(runs, "sweep"):
        if job["grid"][2] == n_view and job["feats"].shape[1] == n_views:
            for r in results:
                np.testing.assert_allclose(r, runs["jax_sweeps"][n_views], atol=2e-5)
            return
    raise AssertionError("no such job")


def test_view_count_must_divide(runs):
    _, results = rank_results(runs, "raises")[0]
    assert all(r == "ValueError: PARALLEL.VIEW=4 must divide the view count 6"
               for r in results)


@pytest.mark.parametrize("n_band", [2, 4])
def test_band_parallel_matches_serial(runs, n_band):
    """Every rank's depth bit-equal to the serial banded forward, with the
    model's own kNN and with the fed one."""
    for job, results in rank_results(runs, "forward"):
        if job["grid"][1] != n_band:
            continue
        serial = runs["port"]["bn_fed" if "pool_file" in job else "bn"]
        for r in results:
            for key in ("coarse_depth_map", "flow1", "flow2"):
                np.testing.assert_array_equal(r[key], serial[key], err_msg=key)


@pytest.mark.parametrize("n_band", [2, 4])
def test_band_parallel_matches_jax(runs, n_band):
    want = runs["jax_band"][0]
    for key in ("flow1", "flow2"):
        assert np.abs(want[key] - want[f"{key}_input"]).max() > 1e-3, key
    for job, results in rank_results(runs, "forward"):
        if job["grid"][1] == n_band and "pool_file" in job:
            for key in ("coarse_depth_map", "flow1", "flow2"):
                np.testing.assert_allclose(results[0][key], want[key], rtol=1e-5, atol=1e-5,
                                           err_msg=key)


def test_predictor_on_a_band_grid(runs):
    """``Predictor(grid=)`` on band groups of 2 ranks: every rank's answer
    bit-equal to the one-process predictor's."""
    (_, results), = rank_results(runs, "predict")
    for r in results:
        assert sorted(r) == sorted(runs["port"]["predictor"])
        for key, v in r.items():
            np.testing.assert_array_equal(v, runs["port"]["predictor"][key], err_msg=key)


def test_data_band_view_grid_matches_jax(runs):
    """2×2×2 through make_eval_step: each data index's rows within 1e-4 of
    the JAX package's eval step, the same on the four ranks of its band and
    view group; the global losses within rtol 1e-4 on every rank."""
    (_, results), = rank_results(runs, "eval_step")
    want, want_losses, _ = runs["jax_combined"]
    for r, res in enumerate(results):
        d = r // 4
        for key in ("coarse_depth_map", "flow1"):
            np.testing.assert_allclose(res["preds"][key], want[key][d:d + 1], rtol=1e-4,
                                       atol=1e-4, err_msg=key)
            np.testing.assert_array_equal(res["preds"][key], results[4 * d]["preds"][key])
        assert sorted(res["losses"]) == sorted(want_losses)
        for k, v in want_losses.items():
            np.testing.assert_allclose(res["losses"][k], v, rtol=1e-4, err_msg=k)
        assert res["metrics"] == results[0]["metrics"]


@pytest.mark.parametrize("name", sorted(CLI_RUNS))
def test_export_on_the_grid_equals_one_rank(runs, name):
    """The test CLI on eight ranks (PARALLEL.BAND 2: four data indices;
    BAND 2 × VIEW 2: two) against one rank, FLOW_CHUNK_ROWS 8 in both: the
    same files, every PFM equal (bit for bit with bands alone), 4 maps
    counted once each on every rank."""
    i = [j for j, job in enumerate(runs["jobs"]) if job["kind"] == "export"][
        sorted(CLI_RUNS).index(name)]
    summaries = [r[i][0] for r in runs["ranks"]]
    depth_dir = runs["ranks"][0][i][1]
    one_summary, one_dir = runs["one_rank"]
    assert one_summary["maps"] == 4 and all(s["maps"] == 4 for s in summaries)
    names = sorted(os.listdir(os.path.join(one_dir, "scan1")))
    assert sorted(os.listdir(os.path.join(depth_dir, "scan1"))) == names
    for f in names:
        if f.endswith(".pfm"):
            got = io.load_pfm(os.path.join(depth_dir, "scan1", f))
            want = io.load_pfm(os.path.join(one_dir, "scan1", f))
            if name == "band":
                np.testing.assert_array_equal(got, want, err_msg=f)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=f)


# ------------------------------------------------------------ the profiler

def test_stage_latencies_keys():
    model = build_model(grid_cfg("bn", 0), "cpu")
    images, cams, _ = make_scene_batch(1, 2, 64, 64, 8, seed=1)
    out = stage_latencies(model, torch.tensor(images), torch.tensor(cams),
                          (0.25, 0.5), (0.75, 0.375), 8, iters=1)
    assert sorted(out) == ["coarse_s", "flow1_iter_s", "flow2_iter_s", "total_s"]
    assert out["coarse_s"] > 0 and out["total_s"] >= out["coarse_s"]


def test_train_stage_latencies_keys_and_state_put_back():
    cfg = grid_cfg("bn", 0)
    model = build_model(cfg, "cpu")
    state = TrainState(model, build_optimizer(cfg, dict(model.named_parameters())))
    images, cams, gt = make_scene_batch(2, 2, 64, 64, 8, seed=1)
    batch = {"images": torch.from_numpy(images), "cams": torch.from_numpy(cams),
             "gt_depth": torch.from_numpy(gt[..., None])}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = train_stage_latencies(state, build_loss_fn(cfg), batch,
                                dict(is_flow=True, img_scales=(0.25,), inter_scales=(0.75,),
                                     num_virtual_plane=8), iters=1)
    assert sorted(out) == sorted(["fwd_s", "bwd_s", "opt_s", "coarse_step_s", "flow_step_s",
                                  "step_s"])
    assert all(np.isfinite(v) for v in out.values()) and out["step_s"] > 0
    assert state.step == 0 and state.optimizer.count == 0 and not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tb")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert os.path.getsize(tmp_path / "tb" / "trace.json") > 0
