"""Export and fusion from a checkpoint the JAX package trained: the port's
test and fuse CLIs against the JAX package's, on the CPU.

The committed fixture ``tests/data/orbax_trained/`` is a TrainState that
the JAX package's ``Checkpointer`` wrote after training with the JAX
package's own calls (those of ``benchmarks/train_synthetic.py``: its data
loader, ``create_train_state``, ``make_train_step``, ``make_eval_step``) on
the CPU, at the full widths of ``configs/dtu_wde3.yaml`` (image and volume
base 8, flow head (64, 64, 16, 1), EdgeConv (32, 32, 64)) under BatchNorm,
k = 16, window 5, f32, on a 64×128 synthetic training tree the JAX package
writes: ``COARSE_EPOCHS`` coarse-only then ``FLOW_EPOCHS`` flow epochs of
``STEPS`` steps. Beside it, ``expected.npz`` holds what the JAX package
computes from it, and the training run's record:

- ``small_*``: the JAX test CLI on scan 1 of an eval-release tree of PNGs
  that the port writes (``make_synthetic_dtu(layout="eval",
  image_ext="png")``: both packages read the same pixels; their JPEG
  decoders differ by a level) at 64×128, V=3, D=16, IMG_SCALES (0.25, 0.5,
  1.0): every exported map of every view; then the JAX fuse CLI (numpy,
  one worker: its thread pool gives wrong float32 products in some runs,
  ROADMAP queue 3) against the scene's true cloud: ``n_points``,
  accuracy, completeness, overall.
- ``paper_*``: the same at the paper-eval config, 640×512, V=5, D=96, f32,
  BN eval, 3 flows (the JAX package's AUTO flow bands, bit-equal to
  unbanded under eval BN): flow3 and prob of view ``paper_view`` and the
  fused cloud over the scan's 5 maps. Too slow to recompute in the suite:
  ``chip_smoke.py`` phase ``trained`` holds the port on the card to them.
- the seeds (the scenes', and the training's ``RNG_SEED`` in its record),
  sizes, scales, fusion settings and a digest of each tree's pixels.

``write_fixture`` rewrites the directory, by hand only, from the
repository's root (about 11 min of CPU: 5 of training, 4 of the
paper-eval maps; the JAX forward at 640×512 peaks near 8.4 GB):

    python -c "import sys; sys.path[:0] = ['tests']; import conftest, \\
        test_torch_trained as t; t.write_fixture()"

The tests run both packages' CLIs once (one module fixture; the JAX test
CLI twice, from the checkpoint and from its own initial weights, on one
compile; torch on one thread) and hold:
- the fixture: what the JAX ``Checkpointer`` wrote, read by
  ``read_orbax`` as orbax restores it, full widths under BN, ≤ 6 MB;
- ``expected.npz``'s small entries to the live JAX run (depth 1e-3, prob
  1e-4: depths are ~450 mm, and f32 rounding on another CPU alone reaches
  ~5e-5);
- the port's exported maps to the JAX CLI's with the bars of
  tests/test_full_parity.py (max |Δ| < 0.05, mean < 0.005; prob < 0.02);
- the port's fused clouds (torch and numpy backends) to the JAX fuse
  CLI's: ``n_points`` within 1%, accuracy, completeness and overall within
  2% relative;
- that the fixture is trained, not flat: the coarse confidence's mean is
  ≥ 3× the JAX package's initial weights', and the fused overall below
  half of theirs.
"""

import contextlib
import functools
import hashlib
import json
import os
import shutil

import jax
import numpy as np
import pytest

from pointmvsnet_tpu.parallel import create_train_state as jcreate_train_state
from pointmvsnet_tpu.postprocess import fuse_depth_maps as jfuse_depth_maps
from pointmvsnet_tpu_torch import fuse, test
from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.dataset import io
from pointmvsnet_tpu_torch.dataset.synthetic import make_synthetic_dtu, true_cloud
from pointmvsnet_tpu_torch.models import build_model
from pointmvsnet_tpu_torch.postprocess import write_ply
from pointmvsnet_tpu_torch.utils.checkpoint import load_weights
from pointmvsnet_tpu_torch.utils.orbax_reader import read_orbax
from test_torch_weights import assert_same_as_orbax
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "orbax_trained")
EXPECTED = os.path.join(FIXTURE, "expected.npz")
CFG_FILE = os.path.join(ROOT, "configs", "dtu_wde3.yaml")
KINDS = ("init", "flow1", "flow2", "flow3", "prob")
SMALL, PAPER = (3, 64, 128, 16), (5, 512, 640, 96)     # V, H, W, D
PAPER_VIEW = 0
# the eval scenes (make_synthetic_dtu's seed) and both test CLIs' settings:
# configs/dtu_wde3.yaml's test scales, the cams' own depth interval
SCENE = dict(scene_seed=0, img_scales=(0.25, 0.5, 1.0), inter_scales=(0.75, 0.375, 0.1875),
             interval_scale=1.0)
# both fuse CLIs' (prob threshold, min views) per config; pix 1 and depth
# 0.01 are their defaults, and V=3 leaves each reference view two sources.
# Each threshold drops part of its maps: 14% of the small config's coarse
# pixels (the trained confidence is above 0.8 nearly everywhere there), and
# all but ~10% of the paper-eval maps', whose confidence is lower at D=96
# than at the D=16 of training; at prob 0 the paper-eval cloud has ~1 M
# points ~8 mm off the scene, minutes of the JAX metrics' KD-tree search
FUSE = {"small": (0.9, 2), "paper": (0.3, 2)}
# the true cloud's pixel stride: every pixel of the small maps, every 4th in
# x and y of the paper-eval maps (102,400 points, 2.6 mm apart on the planes)
GT_STRIDE = {"small": 1, "paper": 4}
# the training run: the JAX script's tree and settings but BN and full widths
TRAIN_SHAPE, TRAIN_SCANS = (4, 64, 128, 16), (2, 6, 7, 8)     # V, H, W, D; train split
STEPS, COARSE_EPOCHS, FLOW_EPOCHS = 56, 16, 3
MAX_BYTES = 6 * 2 ** 20
DEPTH_BAR, DEPTH_MEAN_BAR, PROB_BAR = 0.05, 0.005, 0.02     # tests/test_full_parity.py


# ------------------------------------------------------------------ shared helpers

def eval_scene(work, shape, stride, seed):
    """Scan 1 of the two-plane scene at ``shape`` (V, H, W, D) drawn from
    ``seed``: an eval-release tree of PNGs, and its true cloud
    (``true_cloud`` at ``stride``) as ``<gt>/scan1.ply``. → (tree, gt dir,
    sha256 of the views' pixels)."""
    v, h, w, d = shape
    tree, gt_tree, gt_dir = (os.path.join(work, n) for n in ("eval", "gt_tree", "gt"))
    kw = dict(scans=[1], num_views=v, height=h, width=w, num_depth=d, seed=seed)
    make_synthetic_dtu(tree, layout="eval", image_ext="png", **kw)
    make_synthetic_dtu(gt_tree, num_lights=1, **kw)
    os.makedirs(gt_dir, exist_ok=True)
    write_ply(os.path.join(gt_dir, "scan1.ply"), true_cloud(gt_tree, v, stride=stride))
    digest = hashlib.sha256()
    for i in range(v):
        digest.update(io.read_png(os.path.join(tree, "Eval", "scan1", "images",
                                               f"{i:08d}.png")).tobytes())
    return tree, gt_dir, digest.hexdigest()


def cli_opts(tree, shape, e):
    """Both test CLIs' overrides on top of configs/dtu_wde3.yaml, at
    ``shape`` (V, H, W, D) with the scales of ``e`` (``SCENE``'s keys)."""
    v, h, w, d = shape
    return ["DATA.TEST.ROOT_DIR", tree, "DATA.TEST.NUM_VIEW", str(v),
            "DATA.TEST.NUM_VIRTUAL_PLANE", str(d), "DATA.TEST.IMG_HEIGHT", str(h),
            "DATA.TEST.IMG_WIDTH", str(w),
            "DATA.TEST.INTERVAL_SCALE", str(float(e["interval_scale"])),
            "MODEL.TEST.IMG_SCALES", str(tuple(float(x) for x in e["img_scales"])),
            "MODEL.TEST.INTER_SCALES", str(tuple(float(x) for x in e["inter_scales"]))]


def fuse_opts(gt_dir, prob, views):
    return ["--prob_threshold", str(float(prob)), "--min_views", str(int(views)), "--gt_dir",
            gt_dir]


@contextlib.contextmanager
def jax_test_cli():
    """→ run(opts, out, weight): the JAX test CLI, its depth directory.
    Its template TrainState is drawn once, by a jitted
    ``create_train_state`` (the CLI's eager ``model.init`` takes minutes at
    these widths; the parameters' shapes do not depend on the input's), and
    its eval step is compiled once per model and kwargs. With ``weight`` ""
    the CLI keeps that state: the JAX package's initial weights at
    ``RNG_SEED``."""
    from pointmvsnet_tpu import test as jtest

    init, steps = {}, {}
    make_eval_step = jtest.make_eval_step

    def create(model, opt, rng, example, kw):
        if not init:
            init["state"] = jax.jit(lambda r, ex: jcreate_train_state(model, opt, r, ex, kw))(
                rng, example)
        return init["state"]

    def cached_eval_step(model, loss_fn, metric_fn, mesh, kwargs):
        key = (repr(model), tuple(sorted(kwargs.items())))
        if key not in steps:
            steps[key] = make_eval_step(model, loss_fn, metric_fn, mesh, kwargs)
        return steps[key]

    def run(opts, out, weight):
        jtest.main(["--cfg", CFG_FILE, "OUTPUT_DIR", str(out), "TEST.WEIGHT", weight] + opts)
        return os.path.join(str(out), "depths")

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PMVS_NO_COMPILE_CACHE", "1")
        mp.setattr(jtest, "create_train_state", create)
        mp.setattr(jtest, "make_eval_step", cached_eval_step)
        yield run


def jax_fuse(depth_dir, out, gt_dir, prob, views):
    """The JAX fuse CLI (numpy), its reference views fused serially. →
    scan 1's entry."""
    from pointmvsnet_tpu import fuse as jfuse

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfuse, "fuse_depth_maps", functools.partial(jfuse_depth_maps, num_threads=1))
        jfuse.main(["--depth_dir", depth_dir, "--out", str(out)]
                   + fuse_opts(gt_dir, prob, views))
    with open(os.path.join(str(out), "fusion_results.json")) as f:
        return json.load(f)["scan1"]


def port_export(opts, out, weight):
    _, depth_dir = test.main(["--cfg", CFG_FILE, "--device", "cpu", "OUTPUT_DIR", str(out),
                              "TEST.WEIGHT", weight] + opts)
    return depth_dir


def port_fuse(depth_dir, out, gt_dir, backend, prob, views):
    return fuse.main(["--depth_dir", depth_dir, "--out", str(out), "--backend", backend,
                      "--device", "cpu"] + fuse_opts(gt_dir, prob, views))["scan1"]


def read_maps(depth_dir, v, views=None):
    """→ {kind: (V', h, w)} of the views ``views`` (default all)."""
    views = range(v) if views is None else views
    return {k: np.stack([io.load_pfm(os.path.join(depth_dir, "scan1", f"{i:08d}_{k}.pfm"))
                         for i in views]) for k in KINDS}


def fused_numbers(entry):
    return [entry["n_points"], entry["accuracy"], entry["completeness"], entry["overall"]]


# ------------------------------------------------------------------ the fixture

def train_jax(work):
    """Train the full-width BN model with the JAX package's calls; save the
    TrainState with its Checkpointer under FIXTURE. → the run's record."""
    from pointmvsnet_tpu.config import load_cfg_from_file
    from pointmvsnet_tpu.dataset.build import build_data_loader
    from pointmvsnet_tpu.dataset.synthetic import make_synthetic_dtu as jmake_synthetic_dtu
    from pointmvsnet_tpu.models import build_model as jbuild_model
    from pointmvsnet_tpu.parallel import make_eval_step, make_mesh, make_train_step, replicate
    from pointmvsnet_tpu.parallel import shard_batch
    from pointmvsnet_tpu.utils.checkpoint import Checkpointer
    from pointmvsnet_tpu.utils.solver import build_optimizer

    v, h, w, d = TRAIN_SHAPE
    root = os.path.join(work, "train_tree")
    jmake_synthetic_dtu(root, scans=list(TRAIN_SCANS), num_views=v, height=h, width=w,
                        num_depth=d, depth_min=425.0, depth_interval=2.5)
    cfg = load_cfg_from_file(CFG_FILE)
    cfg.DATA.TRAIN.ROOT_DIR = root
    cfg.DATA.TRAIN.NUM_VIRTUAL_PLANE = d
    cfg.DATA.TRAIN.INTERVAL_SCALE = 1.0
    cfg.MODEL.NUM_VIRTUAL_PLANE = d
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.SOLVER.BASE_LR = 1e-3
    model, loss_fn, metric_fn = jbuild_model(cfg)
    loader = build_data_loader(cfg, "train")
    opt = build_optimizer(cfg, steps_per_epoch=STEPS)
    mesh = make_mesh(1)
    kw_coarse = dict(is_flow=False, img_scales=(), inter_scales=(), num_virtual_plane=d)
    kw_flow = dict(is_flow=True, img_scales=tuple(cfg.MODEL.TRAIN.IMG_SCALES),
                   inter_scales=tuple(cfg.MODEL.TRAIN.INTER_SCALES), num_virtual_plane=d)
    example = next(iter(loader))
    example = {k: example[k] for k in ("images", "cams", "gt_depth")}
    state = jax.jit(lambda r, ex: jcreate_train_state(model, opt, r, ex, kw_flow))(
        jax.random.PRNGKey(cfg.RNG_SEED), example)
    state = replicate(state, mesh)
    record, epoch = {}, 0
    for name, kw, epochs in (("coarse", kw_coarse, COARSE_EPOCHS), ("flow", kw_flow, FLOW_EPOCHS)):
        step = make_train_step(model, loss_fn, opt, mesh, kw)
        ev = make_eval_step(model, loss_fn, metric_fn, mesh, kw)
        snaps = []
        for _ in range(epochs):
            loader.set_epoch(epoch)
            epoch += 1
            for i, batch in enumerate(loader):
                if i >= STEPS:
                    break
                sb = shard_batch({k: batch[k] for k in ("images", "cams", "gt_depth")}, mesh)
                state, losses = step(state, sb)
            _, _, mets = ev(state, sb)
            snaps.append({k: float(x) for k, x in {**losses, **mets}.items()})
            print(f"[{name}] epoch {epoch - 1}: loss {snaps[-1]['total_loss']:.4f} <1 "
                  f"{snaps[-1]['<1_pct_cor']:.3f}", flush=True)
        record[name] = {"epochs": epochs, "steps": epochs * STEPS, "last": snaps[-1]}
    record["rng_seed"] = cfg.RNG_SEED           # the initial weights' PRNGKey
    shutil.rmtree(FIXTURE, ignore_errors=True)
    ck = Checkpointer(FIXTURE)
    ck.save(jax.device_get(state), epoch)
    ck.close()
    return record


def write_fixture():
    """Rewrite tests/data/orbax_trained/ and its expected.npz (by hand only)."""
    import tempfile

    work = tempfile.mkdtemp(prefix="orbax_trained_")
    try:
        record = train_jax(work)
        out = dict(SCENE, train=json.dumps(record), paper_view=PAPER_VIEW)
        with jax_test_cli() as run:
            for name, shape in (("small", SMALL), ("paper", PAPER)):
                tree, gt_dir, digest = eval_scene(os.path.join(work, name), shape,
                                                  GT_STRIDE[name], SCENE["scene_seed"])
                depth_dir = run(cli_opts(tree, shape, SCENE), os.path.join(work, name, "jax"),
                                FIXTURE)
                views = None if name == "small" else [PAPER_VIEW]
                maps = read_maps(depth_dir, shape[0], views)
                keep = KINDS if name == "small" else ("flow3", "prob")
                out.update({f"{name}_{k}": maps[k] for k in keep})
                out[f"{name}_shape"] = list(shape)
                out[f"{name}_digest"] = digest
                out[f"{name}_fuse"] = list(FUSE[name])
                out[f"{name}_gt_stride"] = GT_STRIDE[name]
                out[f"{name}_fused"] = fused_numbers(
                    jax_fuse(depth_dir, os.path.join(work, name, "clouds"), gt_dir, *FUSE[name]))
                print(name, out[f"{name}_fused"], flush=True)
        np.savez(EXPECTED, **out)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------------ the tests

@pytest.fixture(scope="module")
def expected():
    return np.load(EXPECTED)


@pytest.fixture(scope="module")
def runs(expected, tmp_path_factory):
    """Both packages' CLIs at the small config from the fixture, and the JAX
    CLIs from the JAX package's initial weights. → (maps by run: ``jax``,
    ``jax_init``, ``port``; fused clouds by run: ``jax``, ``port_torch``,
    ``port_numpy`` at expected.npz's settings, ``jax_all`` and
    ``jax_init_all`` at prob 0)."""
    work = str(tmp_path_factory.mktemp("trained"))
    shape = tuple(int(x) for x in expected["small_shape"])
    tree, gt_dir, digest = eval_scene(work, shape, int(expected["small_gt_stride"]),
                                      int(expected["scene_seed"]))
    assert digest == str(expected["small_digest"])
    opts = cli_opts(tree, shape, expected)
    with jax_test_cli() as run:
        dirs = {"jax": run(opts, os.path.join(work, "jax"), FIXTURE),
                "jax_init": run(opts, os.path.join(work, "jax_init"), "")}
    dirs["port"] = port_export(opts, os.path.join(work, "port"), FIXTURE)
    maps = {name: read_maps(d, shape[0]) for name, d in dirs.items()}
    fuse_at = tuple(float(x) for x in expected["small_fuse"])
    fused = {"jax": jax_fuse(dirs["jax"], os.path.join(work, "clouds_jax"), gt_dir, *fuse_at)}
    for backend in ("torch", "numpy"):
        fused[f"port_{backend}"] = port_fuse(dirs["port"], os.path.join(work, backend), gt_dir,
                                             backend, *fuse_at)
        assert fused[f"port_{backend}"]["backend"] == backend
    # every pixel to the consistency test: the initial weights' confidence
    # is below the small config's threshold everywhere
    for name in ("jax", "jax_init"):
        fused[f"{name}_all"] = jax_fuse(dirs[name], os.path.join(work, f"all_{name}"), gt_dir,
                                        0.0, fuse_at[1])
    return maps, fused


def test_fixture_is_a_trained_full_width_bn_checkpoint(expected):
    """Written by the JAX package's Checkpointer (read_orbax equals orbax's
    restore, leaf by leaf), ≤ 6 MB, and loadable into the port's model at
    configs/dtu_wde3.yaml's full widths under BN (every weight and running
    statistic, strictly), with running statistics that training moved."""
    size = sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, files in os.walk(FIXTURE) for f in files)
    assert size <= MAX_BYTES, size
    flat = read_orbax(FIXTURE)
    assert_same_as_orbax(flat, FIXTURE)
    cfg = get_default_cfg()
    cfg.merge_from_file(CFG_FILE)
    assert cfg.MODEL.NORM == "bn" and (cfg.MODEL.IMG_BASE_CHANNELS,
                                       cfg.MODEL.VOL_BASE_CHANNELS) == (8, 8)
    model = build_model(cfg, "cpu")
    load_weights(model, FIXTURE)
    assert sum(p.numel() for p in model.parameters()) == 487074
    assert sum(b.numel() for b in model.buffers()) == 1851
    var = [v for k, v in flat.items() if k.startswith("batch_stats/") and k.endswith("/var")]
    assert var and not all(np.allclose(v, 1.0) for v in var)
    record = json.loads(str(expected["train"]))
    assert record["coarse"]["last"]["<1_pct_cor"] >= 0.9
    assert int(flat["step"]) == record["coarse"]["steps"] + record["flow"]["steps"]


def test_expected_is_what_the_jax_package_computes(expected, runs):
    """The small entries against the live JAX CLIs: depth maps within 1e-3,
    prob within 1e-4, the fused numbers within the fusion bars below. The
    paper-eval entries are too slow to recompute here (minutes of CPU at
    640×512); their shapes and values are checked for what they claim."""
    maps, fused = runs
    for k in KINDS:
        bar = 1e-4 if k == "prob" else 1e-3
        d = np.abs(maps["jax"][k] - expected[f"small_{k}"])
        assert d.max() < bar, (k, d.max())
    assert_fused_close(fused_numbers(fused["jax"]), expected["small_fused"])
    v, h, w, d = (int(x) for x in expected["paper_shape"])
    assert (v, h, w, d) == PAPER
    assert expected["paper_flow3"].shape == (1, h, w) and np.isfinite(expected["paper_flow3"]).all()
    assert expected["paper_prob"].shape[0] == 1 and np.isfinite(expected["paper_prob"]).all()
    assert np.isfinite(expected["paper_fused"]).all() and expected["paper_fused"][0] > 0


@pytest.mark.parametrize("kind", KINDS)
def test_port_export_matches_jax_cli(runs, kind):
    """Each exported map of every view, the port's test CLI against the JAX
    CLI's from the same checkpoint and tree."""
    maps, _ = runs
    got, want = maps["port"][kind], maps["jax"][kind]
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got - want)
    if kind == "prob":
        assert d.max() < PROB_BAR, d.max()
    else:
        assert d.max() < DEPTH_BAR and d.mean() < DEPTH_MEAN_BAR, (d.max(), d.mean())


def assert_fused_close(got, want):
    """n_points within 1%; accuracy, completeness and overall within 2%
    relative."""
    n, metrics = got[0], np.asarray(got[1:], np.float64)
    assert abs(n - want[0]) <= 0.01 * want[0], (n, want[0])
    np.testing.assert_allclose(metrics, np.asarray(want[1:], np.float64), rtol=0.02)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_port_fusion_matches_jax_fuse(runs, backend):
    _, fused = runs
    assert_fused_close(fused_numbers(fused[f"port_{backend}"]), fused_numbers(fused["jax"]))


def test_fixture_is_trained_not_flat(runs):
    """From the JAX package's initial weights (the test CLI without
    TEST.WEIGHT) the coarse softmax is flat (over D=16 a flat one gives a
    confidence of 3/16 where ties send the argmax to the first plane) and
    the fused cloud far off; from the checkpoint the mean confidence is at
    least 3× theirs and the fused overall below half of theirs, both fused
    at prob 0 (the initial confidence is below every threshold)."""
    maps, fused = runs
    conf, conf0 = maps["jax"]["prob"].mean(), maps["jax_init"]["prob"].mean()
    assert conf >= 3 * conf0, (conf, conf0)
    overall, overall0 = fused["jax_all"]["overall"], fused["jax_init_all"]["overall"]
    assert np.isfinite(overall0) and overall < 0.5 * overall0, (overall, overall0)
