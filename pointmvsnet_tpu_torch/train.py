"""Training entry point: counterpart of ``pointmvsnet_tpu/train.py``.

    python -m pointmvsnet_tpu_torch.train [--cfg configs/dtu_wde3.yaml] \\
        [--device cuda|cpu] DATA.TRAIN.ROOT_DIR data/dtu TRAIN.BATCH_SIZE 4
    torchrun --nproc_per_node=N -m pointmvsnet_tpu_torch.train ...   # N cards

Epoch loop with the coarse-only curriculum (PointFlow off for the first
``SCHEDULER.INIT_EPOCH`` epochs), losses logged every ``TRAIN.LOG_PERIOD``
steps, validation every ``TRAIN.VAL_PERIOD`` epochs, a checkpoint per
``TRAIN.CHECKPOINT_PERIOD`` epochs and auto-resume from the newest. The
weights start from torch's default initialisation under ``RNG_SEED`` (conv
and dense kernels uniform in ±1/√fan_in, as the JAX package's
``conv_kernel_init``; BatchNorm at identity), on every rank. ``MODEL.DTYPE``
float32 or bfloat16 (parameters and optimizer state stay f32). Under
torchrun the run is data-parallel over the launch's processes
(``PARALLEL.DATA`` -1 or the world size; ``parallel/distributed.py``):
``TRAIN.BATCH_SIZE`` is the global batch, rank 0 logs and writes the
checkpoints.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from pointmvsnet_tpu_torch import disable_tf32, resolve_device
from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.dataset.build import build_data_loader
from pointmvsnet_tpu_torch.models import build_loss_fn, build_model, pointmvsnet_metrics
from pointmvsnet_tpu_torch.parallel import (
    TrainState,
    distributed,
    make_eval_step,
    make_train_step,
    put_batch,
)
from pointmvsnet_tpu_torch.utils.checkpoint import Checkpointer
from pointmvsnet_tpu_torch.utils.logger import setup_logger
from pointmvsnet_tpu_torch.utils.metric_logger import MetricLogger
from pointmvsnet_tpu_torch.utils.solver import MAX_CONSECUTIVE_NONFINITE, build_optimizer
from pointmvsnet_tpu_torch.utils.tensorboard_logger import TensorboardLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Point-MVSNet training (PyTorch port)")
    p.add_argument("--cfg", default="", help="config YAML path (needs PyYAML)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="dotted-path config overrides, e.g. TRAIN.BATCH_SIZE 2")
    return p.parse_args(argv)


def _model_kwargs(cfg, is_flow: bool) -> Dict:
    return dict(
        is_flow=is_flow,
        img_scales=tuple(cfg.MODEL.TRAIN.IMG_SCALES),
        inter_scales=tuple(cfg.MODEL.TRAIN.INTER_SCALES),
        num_virtual_plane=cfg.MODEL.NUM_VIRTUAL_PLANE,
    )


def train(cfg, output_dir: str, max_steps_per_epoch: Optional[int] = None,
          device="cuda") -> TrainState:
    """Run the epochs from the newest checkpoint (if ``AUTO_RESUME``) to
    ``SCHEDULER.MAX_EPOCH``. → the final TrainState."""
    dev = resolve_device(device)
    disable_tf32()
    world = distributed.init_data_parallel(cfg.PARALLEL.DATA, dev)
    logger = setup_logger("pointmvsnet_tpu_torch.train", output_dir)
    tb = TensorboardLogger(os.path.join(output_dir, "tb"))

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.RNG_SEED)
        model = build_model(cfg, dev)
    distributed.assert_replicated(model)
    loss_fn = build_loss_fn(cfg)
    flow_capable = cfg.MODEL.NAME != "mvsnet"

    train_loader = build_data_loader(cfg, "train")
    val_loader = build_data_loader(cfg, "val")
    if len(train_loader) == 0:
        raise RuntimeError(
            f"empty train loader: dataset smaller than TRAIN.BATCH_SIZE="
            f"{cfg.TRAIN.BATCH_SIZE} with drop_last, or ROOT_DIR="
            f"{cfg.DATA.TRAIN.ROOT_DIR!r} has no scans")
    steps_per_epoch = (min(len(train_loader), max_steps_per_epoch)
                       if max_steps_per_epoch else len(train_loader))
    state = TrainState(model, build_optimizer(cfg, dict(model.named_parameters()),
                                               steps_per_epoch))
    logger.info("device: %s, %d rank(s), global batch %d",
                torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu", world,
                cfg.TRAIN.BATCH_SIZE)

    checkpointer = Checkpointer(os.path.join(output_dir, "checkpoints"))
    state, start_epoch = checkpointer.load(state, resume=cfg.AUTO_RESUME)
    if start_epoch:
        logger.info("auto-resumed at epoch %d", start_epoch)

    for epoch in range(start_epoch, cfg.SCHEDULER.MAX_EPOCH):
        is_flow = flow_capable and epoch >= cfg.SCHEDULER.INIT_EPOCH
        step_fn = make_train_step(loss_fn, _model_kwargs(cfg, is_flow))
        eval_fn = make_eval_step(loss_fn, pointmvsnet_metrics, _model_kwargs(cfg, is_flow))

        # ---- train epoch -------------------------------------------------
        # losses are read back (a host sync) only at LOG_PERIOD
        train_loader.set_epoch(epoch)
        meters = MetricLogger()
        window_start = time.time()
        window_data = 0.0
        window_steps = 0
        losses = {}
        tic = time.time()
        for it, batch in enumerate(train_loader):
            if max_steps_per_epoch and it >= max_steps_per_epoch:
                break
            window_data += time.time() - tic
            state, losses = step_fn(state, put_batch(batch, dev))
            window_steps += 1
            if it % cfg.TRAIN.LOG_PERIOD == 0:
                losses_f = {k: float(v) for k, v in losses.items()}
                consec = losses_f.pop("consecutive_skipped")
                if losses_f["skipped_steps"] > 0:
                    logger.warning(
                        "epoch %d iter %d: %d non-finite step(s) skipped so far "
                        "(%d consecutive)", epoch, it, int(losses_f["skipped_steps"]),
                        int(consec))
                if consec >= MAX_CONSECUTIVE_NONFINITE // 2:
                    raise RuntimeError(
                        f"{int(consec)} consecutive non-finite gradient steps "
                        f"(SOLVER.SKIP_NONFINITE); aborting before the optimizer "
                        f"would apply a non-finite update after "
                        f"{MAX_CONSECUTIVE_NONFINITE}")
                elapsed = time.time() - window_start
                meters.update(batch_time=(elapsed - window_data) / window_steps,
                              data_time=window_data / window_steps, **losses_f)
                logger.info("epoch %d iter %d/%d  %s", epoch, it, steps_per_epoch, meters)
                window_start = time.time()
                window_data = 0.0
                window_steps = 0
            tic = time.time()
        losses.pop("consecutive_skipped", None)
        meters.update(**{k: float(v) for k, v in losses.items()})
        tb.add_scalars(meters.summary, epoch, prefix="train/")

        # ---- validation --------------------------------------------------
        if cfg.TRAIN.VAL_PERIOD and (epoch + 1) % cfg.TRAIN.VAL_PERIOD == 0 \
                and len(val_loader) > 0:
            vmeters = MetricLogger()
            for it, batch in enumerate(val_loader):
                if max_steps_per_epoch and it >= max_steps_per_epoch:
                    break
                _, vlosses, metrics = eval_fn(state, put_batch(batch, dev))
                vmeters.update(**{k: float(v) for k, v in vlosses.items()},
                               **{k: float(v) for k, v in metrics.items()})
            logger.info("epoch %d VAL  %s", epoch, vmeters)
            tb.add_scalars(vmeters.summary, epoch, prefix="val/")

        if (epoch + 1) % cfg.TRAIN.CHECKPOINT_PERIOD == 0 \
                or epoch + 1 == cfg.SCHEDULER.MAX_EPOCH:
            checkpointer.save(state, epoch)
            logger.info("saved checkpoint for epoch %d", epoch)

    tb.close()
    checkpointer.close()
    return state


def main(argv=None) -> TrainState:
    args = parse_args(argv)
    if args.cfg:
        try:
            import yaml  # noqa: F401  (CfgNode.merge_from_file needs it)
        except ImportError as e:
            raise RuntimeError(
                f"--cfg {args.cfg} needs PyYAML, which is not installed: give "
                f"the overrides on the command line without --cfg, or build the "
                f"config in code and call train()") from e
    cfg = get_default_cfg()
    if args.cfg:
        cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    output_dir = cfg.OUTPUT_DIR
    if output_dir == "@":
        stem = os.path.splitext(os.path.basename(args.cfg))[0] if args.cfg else "default"
        output_dir = os.path.join("outputs", stem)
    os.makedirs(output_dir, exist_ok=True)
    distributed.init_data_parallel(cfg.PARALLEL.DATA, resolve_device(args.device))
    logger = setup_logger("pointmvsnet_tpu_torch", output_dir)
    logger.info("config %s, overrides %s", args.cfg or "(defaults)", args.opts)
    np.random.seed(cfg.RNG_SEED)
    return train(cfg, output_dir, device=args.device)


if __name__ == "__main__":
    main()
