"""The port's learning run (``pointmvsnet_tpu_torch/benchmarks/
train_synthetic.py``) against the JAX package's loop of
``benchmarks/train_synthetic.py``, built from the calls that script makes
(its ``main`` hard-codes the default widths, too slow to compile here).

Both loops read one synthetic tree that the JAX package writes with the
script's arguments, at 64×64 (the smallest input the model takes: both
sides divisible by 64), with narrow widths, 2 steps per epoch and the
script's 2 + 2 epochs, from the same weights (the JAX package's
``create_train_state`` init, converted). Two settings are the test's own,
in both packages:
- ``SOLVER.TYPE`` SGD (momentum 0.9). RMSprop's first update moves every
  weight whose gradient exceeds ε by about ±lr·√10, so a near-zero
  gradient whose sign differs between the packages moves a weight by twice
  that and the curves part for reasons unrelated to the loop.
- the JAX EdgeConv max routes its gradient to the argmax
  (``test_torch_train_step.ArgmaxRoutedNumpy``): ``jnp.max``'s own
  gradient is wrong in the jitted step on the CPU.

Per step the losses (``total_loss`` and each output's), ``<1_pct_cor``,
``<1_pct_flow2`` in the flow phase, and the learning rate in force are held
to the JAX loop's: the rates to rounding (the flow phase's 0.9·lr shows
that the schedule counts across both phases), the losses within rtol 1e-3,
each metric within 8 pixels of its map (B·h·w: 512 for the coarse map and
flow1, 2048 for flow2). Measured: every coarse-phase metric equal and its
losses within 1.2e-6; in the flow phase the losses within 5.2e-5 and the
metrics equal but at the last step, where 5 pixels of flow2 (<1) and 3 of
flow1 (<3) lie on the other side of a threshold. EdgeConv's max over K
has near-ties on the smooth synthetic texture, and a tie resolved the
other way sends a gradient to another neighbour
(tests/test_torch_train_step.py), so the weights part by a little in
every flow step.
"""

import ast
import contextlib
import io
import os
import re
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest

import pointmvsnet_tpu.models.edge_conv as jedge_conv
from pointmvsnet_tpu.config import get_default_cfg as jget_default_cfg
from pointmvsnet_tpu.dataset.build import build_data_loader as jbuild_data_loader
from pointmvsnet_tpu.dataset.synthetic import make_synthetic_dtu as jmake_synthetic_dtu
from pointmvsnet_tpu.models import build_model as jbuild_model
from pointmvsnet_tpu.parallel import (
    create_train_state,
    make_mesh,
    replicate,
    shard_batch,
)
from pointmvsnet_tpu.parallel import make_eval_step as jmake_eval_step
from pointmvsnet_tpu.parallel import make_train_step as jmake_train_step
from pointmvsnet_tpu.utils.solver import build_lr_schedule as jbuild_lr_schedule
from pointmvsnet_tpu.utils.solver import build_optimizer as jbuild_optimizer
from pointmvsnet_tpu_torch.benchmarks import train_synthetic
from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.dataset import io as tio
from pointmvsnet_tpu_torch.utils.convert import jax_to_torch
from test_torch_model import flatten
from test_torch_train_step import ArgmaxRoutedNumpy
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(ROOT, "benchmarks", "train_synthetic.py")
H, W, D = 64, 64, 16
STEPS = 2
LOSS_RTOL = 1e-3
METRIC_PIXELS = 8
PIXELS = {"cor": 2 * 16 * 16, "flow1": 2 * 16 * 16, "flow2": 2 * 32 * 32}   # B·h·w
COMPARED = ("total_loss", "coarse_loss", "flow1_loss", "flow2_loss", "<1_pct_cor",
            "<1_pct_flow2", "<3_pct_cor", "<3_pct_flow2")


def narrow(cfg):
    """The widths of test_torch_train_step.tiny, and SGD."""
    cfg.MODEL.IMG_BASE_CHANNELS = 4
    cfg.MODEL.VOL_BASE_CHANNELS = 4
    cfg.MODEL.EDGE_CHANNELS = (8, 8)
    cfg.MODEL.FLOW_CHANNELS = (8, 1)
    cfg.SOLVER.TYPE = "SGD"
    return cfg


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX script's tree (its lines 40-43) at H×W."""
    root = str(tmp_path_factory.mktemp("synth_dtu"))
    jmake_synthetic_dtu(root, scans=[2, 6], num_views=4, height=H, width=W, num_depth=D,
                        depth_min=425.0, depth_interval=2.5)
    return root


def schedule_count(opt_state) -> int:
    """The optimizer's update count, from its ScaleByScheduleState."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByScheduleState))
        if isinstance(s, optax.ScaleByScheduleState)]
    assert len(found) == 1
    return int(found[0].count)


@pytest.fixture(scope="module")
def jax_run(tree):
    """The JAX script's loop (its lines 45-94) on ``tree``. → (snapshots by
    phase, each with ``lr``; the initial variables, flat)."""
    cfg = narrow(jget_default_cfg())
    cfg.DATA.TRAIN.ROOT_DIR = tree
    cfg.DATA.TRAIN.NUM_VIRTUAL_PLANE = D
    cfg.DATA.TRAIN.INTERVAL_SCALE = 1.0
    cfg.MODEL.NUM_VIRTUAL_PLANE = D
    cfg.MODEL.NORM = "gn"
    cfg.MODEL.TRAIN.IMG_SCALES = (0.25, 0.5)
    cfg.MODEL.TRAIN.INTER_SCALES = (0.75, 0.375)
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.SOLVER.BASE_LR = 1e-3

    model, loss_fn, metric_fn = jbuild_model(cfg)
    loader = jbuild_data_loader(cfg, "train")
    opt = jbuild_optimizer(cfg, steps_per_epoch=STEPS)
    sched = jbuild_lr_schedule(cfg, STEPS)
    mesh = make_mesh(1)
    kw_coarse = dict(is_flow=False, img_scales=(), inter_scales=(), num_virtual_plane=D)
    kw_flow = dict(is_flow=True, img_scales=tuple(cfg.MODEL.TRAIN.IMG_SCALES),
                   inter_scales=tuple(cfg.MODEL.TRAIN.INTER_SCALES), num_virtual_plane=D)
    example = next(iter(loader))
    example = {k: example[k] for k in ("images", "cams", "gt_depth")}
    # jitted: the same init, one compile instead of minutes op by op
    state = jax.jit(lambda rng, ex: create_train_state(model, opt, rng, ex, kw_flow))(
        jax.random.PRNGKey(0), example)
    init = {k: np.asarray(v) for k, v in
            flatten({"params": state.params, "batch_stats": state.batch_stats}).items()}
    state = replicate(state, mesh)

    snapshots = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jedge_conv, "jnp", ArgmaxRoutedNumpy())
        for name, kw in (("coarse", kw_coarse), ("flow", kw_flow)):
            step = jmake_train_step(model, loss_fn, opt, mesh, kw)
            ev = jmake_eval_step(model, loss_fn, metric_fn, mesh, kw)
            snaps = snapshots[name] = []
            for ep in range(2):
                loader.set_epoch(ep)
                for i, batch in enumerate(loader):
                    if i >= STEPS:
                        break
                    sb = shard_batch({k: batch[k] for k in ("images", "cams", "gt_depth")},
                                     mesh)
                    lr = float(sched(schedule_count(state.opt_state)))
                    state, losses = step(state, sb)
                    _, _, mets = ev(state, sb)
                    snaps.append(dict({k: float(v) for k, v in {**losses, **mets}.items()},
                                      lr=lr))
    return snapshots, init


@pytest.fixture(scope="module")
def port_run(tree, jax_run):
    _, init = jax_run
    return train_synthetic.run(narrow(get_default_cfg()), tree, STEPS, device="cpu",
                               init_state=jax_to_torch(init))


@pytest.mark.parametrize("phase", ["coarse", "flow"])
def test_steps_match_the_jax_loop(jax_run, port_run, phase):
    want, got = jax_run[0][phase], port_run.snapshots[phase]
    assert len(got) == len(want) == 2 * STEPS
    for i, (w, g) in enumerate(zip(want, got)):
        assert g["skipped_steps"] == w["skipped_steps"] == 0
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6), (phase, i)
        for k in COMPARED:
            if k not in w:
                assert phase == "coarse" and "flow" in k and k not in g
                continue
            assert np.isfinite(g[k]), (phase, i, k)
            if "pct" in k:
                bar = METRIC_PIXELS / PIXELS[k.rsplit("_", 1)[1]]
                assert abs(g[k] - w[k]) <= bar, (phase, i, k, g[k], w[k])
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                           err_msg=f"{phase} step {i} {k}")
    assert (port_run.coarse[0], port_run.coarse[1]) == (port_run.snapshots["coarse"][0],
                                                        port_run.snapshots["coarse"][-1])


def test_schedule_counts_across_phases(jax_run, port_run):
    """STEP_SIZE 2 epochs of 2 steps: 4 coarse updates at BASE_LR, the
    flow phase at 0.9·BASE_LR, in both packages."""
    rates = [s["lr"] for p in ("coarse", "flow") for s in port_run.snapshots[p]]
    np.testing.assert_allclose(rates, [1e-3] * 4 + [9e-4] * 4, rtol=1e-6)
    np.testing.assert_allclose(rates, [s["lr"] for p in ("coarse", "flow")
                                       for s in jax_run[0][p]], rtol=1e-6)
    assert port_run.state.optimizer.count == port_run.state.step == 4 * STEPS


def test_flow_phase_sees_the_coarse_batches(tree):
    """Both phases restart the loader at epoch 0: the same batch order."""
    from pointmvsnet_tpu_torch.dataset.build import build_data_loader
    cfg = train_synthetic.configure(get_default_cfg(), tree)
    loader = build_data_loader(cfg, "train")
    order = []
    for _ in range(2):
        for ep in range(2):
            loader.set_epoch(ep)
            order.append([(int(b["scan"][j]), int(b["ref_view"][j]))
                          for i, b in zip(range(STEPS), loader) for j in range(2)])
    assert order[:2] == order[2:] and order[0] != order[1]


def jax_summary(c_first, c_last, f_first, f_last):
    """The JAX script's own lines after its two phases (summary, verdict,
    exit code), run on the given snapshots. → (stdout, return value)."""
    with open(JAX_SCRIPT) as f:
        main = next(n for n in ast.parse(f.read()).body
                    if isinstance(n, ast.FunctionDef) and n.name == "main")
    start = next(i for i, n in enumerate(main.body) if isinstance(n, ast.Assign)
                 and "f_first" in ast.unparse(n.targets[0])) + 1
    tail = ast.FunctionDef(name="tail", args=ast.arguments(
        posonlyargs=[], args=[ast.arg(a) for a in ("c_first", "c_last", "f_first", "f_last")],
        kwonlyargs=[], kw_defaults=[], defaults=[]), body=main.body[start:],
        decorator_list=[], type_params=[])
    ns = {}
    exec(compile(ast.fix_missing_locations(ast.Module([tail], [])), JAX_SCRIPT, "exec"), ns)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ns["tail"](c_first, c_last, f_first, f_last)
    return out.getvalue(), rc


SNAPS = {
    "learns": ({"total_loss": 3.39721, "<1_pct_cor": 0.0},
               {"total_loss": 0.51234, "<1_pct_cor": 0.9843},
               {"total_loss": 2.0, "<1_pct_flow2": 0.25},
               {"total_loss": 1.25, "<1_pct_flow2": 0.75}),
    "loss_up": ({"total_loss": 1.0, "<1_pct_cor": 0.1}, {"total_loss": 1.5, "<1_pct_cor": 0.2},
                {"total_loss": 2.0}, {"total_loss": 1.0}),
    "pct_flat": ({"total_loss": 2.0, "<1_pct_cor": 0.5}, {"total_loss": 1.0, "<1_pct_cor": 0.5},
                 {"total_loss": 2.0, "<1_pct_flow2": 0.1}, {"total_loss": 1.0}),
    "equal": ({"total_loss": 1.0, "<1_pct_cor": 0.3}, {"total_loss": 1.0, "<1_pct_cor": 0.4},
              {"total_loss": 1.0}, {"total_loss": 1.0}),
}


@pytest.mark.parametrize("case", sorted(SNAPS))
def test_summary_and_rule_match_the_jax_script(case):
    snaps = SNAPS[case]
    want_out, want_rc = jax_summary(*snaps)
    assert "\n".join(train_synthetic.summary_lines(*snaps)) + "\n" == want_out
    assert (0 if train_synthetic.learning_ok(*snaps[:2]) else 1) == want_rc
    assert want_rc == (0 if case == "learns" else 1)


def test_make_tree_writes_the_jax_scripts_scene(tree, tmp_path):
    """Same files, cameras and depth maps as the JAX script's tree (the
    pixels differ: the port renders without cv2)."""
    train_synthetic.make_tree(str(tmp_path), H, W)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                   for d, _, fs in os.walk(tmp_path) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), tree)
                           for d, _, fs in os.walk(tree) for f in fs)
    for f in files:
        if f.endswith("_cam.txt"):
            np.testing.assert_array_equal(tio.load_cam(str(tmp_path / f)),
                                          tio.load_cam(os.path.join(tree, f)))
        elif f.endswith(".pfm"):
            np.testing.assert_array_equal(tio.load_pfm(str(tmp_path / f)),
                                          tio.load_pfm(os.path.join(tree, f)))


def test_main_exit_code_follows_its_numbers(capsys):
    """The CLI at the default widths on the CPU: its epoch and summary
    lines, and an exit code that agrees with learning_ok on the numbers it
    printed."""
    rc = train_synthetic.main(["--steps", "1", "--height", "64", "--width", "64",
                               "--device", "cpu"])
    out = capsys.readouterr().out
    epochs = re.findall(r"^\[(coarse|flow)\] epoch (\d): loss [\d.]+ <1int [\d.]+$", out, re.M)
    assert epochs == [("coarse", "0"), ("coarse", "1"), ("flow", "0"), ("flow", "1")]
    num = r"(-?[\d.]+|nan|inf)"
    c = re.search(rf"^coarse phase:  loss {num} -> {num}   <1int {num} -> {num}$", out, re.M)
    f = re.search(rf"^flow  phase:  loss {num} -> {num}   <1int\(flow2\) {num} -> {num}$",
                  out, re.M)
    assert c and f, out
    first = {"total_loss": float(c[1]), "<1_pct_cor": float(c[3])}
    last = {"total_loss": float(c[2]), "<1_pct_cor": float(c[4])}
    ok = train_synthetic.learning_ok(first, last)
    assert out.rstrip().endswith("LEARNING: " + ("OK" if ok else "NOT IMPROVING"))
    assert rc == (0 if ok else 1)
    assert all(np.isfinite(float(x)) for x in (*c.groups(), *f.groups()))


def test_module_imports_no_jax():
    code = ("import sys\n"
            "import pointmvsnet_tpu_torch.benchmarks.train_synthetic\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'pointmvsnet_tpu' or m.startswith('pointmvsnet_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True)
    assert out.stdout.strip() == "[]"


def test_runs_on_cuda_by_default(monkeypatch):
    """No silent CPU fallback: without a GPU the default device raises."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_synthetic.main(["--steps", "1", "--height", "64", "--width", "64"])

