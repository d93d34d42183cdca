"""End-to-end learning run: train on synthetic DTU-format scenes and check
that depth accuracy improves. Counterpart of ``benchmarks/train_synthetic.py``.

The synthetic scenes are exact renders of two textured planes, so a working
pipeline must drive the <1-interval accuracy up sharply. GroupNorm, B=2,
RMSprop at 1e-3 on scans 2 and 6 (4 views, D=16): two coarse-only epochs,
then two epochs with both PointFlow iterations. One model and one optimizer
span both phases, so the StepLR schedule counts every update; each phase
restarts the loader's epochs at 0, so the flow phase sees the coarse
phase's batches in the same order. After each train step the eval step
scores the same batch with the updated weights: a snapshot is the step's
losses and those metrics.

    python -m pointmvsnet_tpu_torch.benchmarks.train_synthetic [--steps 30] \\
        [--height 64] [--width 128] [--device cuda|cpu]

Prints the loss and <1-interval accuracy at the end of each epoch, each
phase's first → last numbers and ``LEARNING: OK`` (exit 0) when the coarse
phase's loss fell and its <1-interval accuracy rose, else
``LEARNING: NOT IMPROVING`` (exit 1). Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch

from pointmvsnet_tpu_torch import disable_tf32, resolve_device
from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.dataset.build import build_data_loader
from pointmvsnet_tpu_torch.dataset.synthetic import make_synthetic_dtu
from pointmvsnet_tpu_torch.models import build_loss_fn, build_model, pointmvsnet_metrics
from pointmvsnet_tpu_torch.parallel import TrainState, make_eval_step, make_train_step, put_batch
from pointmvsnet_tpu_torch.utils.solver import build_optimizer

SCANS = (2, 6)                 # train split (dataset/splits.py)
NUM_VIEWS = 4
NUM_DEPTH = 16
DEPTH_MIN, DEPTH_INTERVAL = 425.0, 2.5
PHASES = (("coarse", False, 2), ("flow", True, 2))     # (name, is_flow, epochs)


class LearningRun(NamedTuple):
    coarse: Tuple[dict, dict]            # the phase's first and last snapshot
    flow: Tuple[dict, dict]
    snapshots: Dict[str, List[dict]]     # phase → every step's snapshot
    state: TrainState


def make_tree(root: str, height: int, width: int) -> None:
    make_synthetic_dtu(root, scans=SCANS, num_views=NUM_VIEWS, height=height, width=width,
                       num_depth=NUM_DEPTH, depth_min=DEPTH_MIN, depth_interval=DEPTH_INTERVAL)


def configure(cfg, root: str):
    """A copy of ``cfg`` with the run's data, model and solver settings;
    every other key (widths, MODEL.DTYPE, SOLVER.TYPE) stays the caller's."""
    cfg = cfg.clone()
    cfg.DATA.TRAIN.ROOT_DIR = root
    cfg.DATA.TRAIN.NUM_VIRTUAL_PLANE = NUM_DEPTH
    cfg.DATA.TRAIN.INTERVAL_SCALE = 1.0
    cfg.MODEL.NUM_VIRTUAL_PLANE = NUM_DEPTH
    cfg.MODEL.NORM = "gn"
    cfg.MODEL.TRAIN.IMG_SCALES = (0.25, 0.5)
    cfg.MODEL.TRAIN.INTER_SCALES = (0.75, 0.375)
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.SOLVER.BASE_LR = 1e-3
    return cfg


def run(cfg, root: str, steps: int, device="cuda",
        init_state: Optional[Mapping[str, torch.Tensor]] = None,
        log: Optional[Callable[[str], None]] = None) -> LearningRun:
    """Both phases on the tree at ``root`` (``make_tree``), at most ``steps``
    steps per epoch. The weights come from ``init_state`` (a state_dict),
    else from torch's default initialisation under ``cfg.RNG_SEED``, as
    ``train.train`` draws them. ``log`` gets one line per epoch. Each
    snapshot also holds ``lr``, the rate of the step's update."""
    dev = resolve_device(device)
    disable_tf32()
    cfg = configure(cfg, root)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.RNG_SEED)
        model = build_model(cfg, dev)
    if init_state is not None:
        model.load_state_dict(init_state)
    loss_fn = build_loss_fn(cfg)
    loader = build_data_loader(cfg, "train")
    state = TrainState(model, build_optimizer(cfg, dict(model.named_parameters()),
                                              steps_per_epoch=steps))

    snapshots: Dict[str, List[dict]] = {}
    for name, is_flow, epochs in PHASES:
        kw = dict(is_flow=is_flow,
                  img_scales=tuple(cfg.MODEL.TRAIN.IMG_SCALES) if is_flow else (),
                  inter_scales=tuple(cfg.MODEL.TRAIN.INTER_SCALES) if is_flow else (),
                  num_virtual_plane=NUM_DEPTH)
        step = make_train_step(loss_fn, kw)
        ev = make_eval_step(loss_fn, pointmvsnet_metrics, kw)
        snaps = snapshots[name] = []
        for ep in range(epochs):
            loader.set_epoch(ep)
            for i, batch in enumerate(loader):
                if i >= steps:
                    break
                batch = put_batch(batch, dev)
                lr = state.optimizer.lr(state.optimizer.count)
                state, losses = step(state, batch)
                _, _, mets = ev(state, batch)
                snaps.append(dict({k: float(v) for k, v in {**losses, **mets}.items()}, lr=lr))
            if log is not None:
                last = snaps[-1]
                log(f"[{name}] epoch {ep}: loss {last['total_loss']:.4f} "
                    f"<1int {last.get('<1_pct_cor', 0):.3f}")
    return LearningRun((snapshots["coarse"][0], snapshots["coarse"][-1]),
                       (snapshots["flow"][0], snapshots["flow"][-1]), snapshots, state)


def learning_ok(c_first: Mapping[str, float], c_last: Mapping[str, float]) -> bool:
    """The coarse phase's loss fell and its <1-interval accuracy rose."""
    return (c_last["total_loss"] < c_first["total_loss"]
            and c_last["<1_pct_cor"] > c_first["<1_pct_cor"])


def summary_lines(c_first, c_last, f_first, f_last) -> List[str]:
    """The two phase lines and the verdict, as ``main`` prints them."""
    return [
        "\ncoarse phase:  loss %.4f -> %.4f   <1int %.3f -> %.3f" % (
            c_first["total_loss"], c_last["total_loss"],
            c_first["<1_pct_cor"], c_last["<1_pct_cor"]),
        "flow  phase:  loss %.4f -> %.4f   <1int(flow2) %.3f -> %.3f" % (
            f_first["total_loss"], f_last["total_loss"],
            f_first.get("<1_pct_flow2", 0), f_last.get("<1_pct_flow2", 0)),
        "LEARNING: " + ("OK" if learning_ok(c_first, c_last) else "NOT IMPROVING"),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="learning run on synthetic DTU scenes "
                                             "(PyTorch port)")
    ap.add_argument("--steps", type=int, default=30, help="steps per epoch")
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="synth_dtu_") as root:
        make_tree(root, args.height, args.width)
        res = run(get_default_cfg(), root, args.steps, args.device, log=print)
    for line in summary_lines(*res.coarse, *res.flow):
        print(line)
    return 0 if learning_ok(*res.coarse) else 1


if __name__ == "__main__":
    raise SystemExit(main())
