"""Evaluation / depth-map export entry point: counterpart of
``pointmvsnet_tpu/test.py``.

    python -m pointmvsnet_tpu_torch.test [--cfg configs/dtu_wde3.yaml] \\
        [--device cuda|cpu] TEST.WEIGHT <ckpt.pt, dir or orbax dir> DATA.TEST.ROOT_DIR ...

No-grad loop over the test split (DTU or Tanks & Temples) at the eval
settings, per-batch losses and depth metrics where the split has GT
depth, and the MVSNet-format export that ``fuse.py`` reads
(``OUTPUT_DIR/depths/scan<n>/``). The weights come from ``TEST.WEIGHT``
(a ``.pt`` file, a directory of ``<epoch>.pt`` files, or an orbax
checkpoint the JAX package wrote: its manager root, a step or an item
directory; ``utils/checkpoint.py::load_weights``), else from the newest
checkpoint under ``OUTPUT_DIR/checkpoints``, else from ``cfg.RNG_SEED``
(``utils.convert.init_params``, as ``Predictor``); the log names which.
A reference Point-MVSNet ``.pth`` is converted first
(``utils/torch_convert.py``).
Under torchrun (``PARALLEL.DATA`` -1 or the world size) each rank exports
every W-th item of the split into the same depth directory, with
``TEST.BATCH_SIZE`` items per batch, and the summary is over every rank's
batches. Band- and view-parallel eval (``PARALLEL.BAND`` / ``VIEW`` > 1)
are not ported (ROADMAP queue 1).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch

from pointmvsnet_tpu_torch import disable_tf32, resolve_device
from pointmvsnet_tpu_torch.config import get_default_cfg
from pointmvsnet_tpu_torch.dataset.build import build_data_loader
from pointmvsnet_tpu_torch.models import build_loss_fn, build_model, pointmvsnet_metrics
from pointmvsnet_tpu_torch.parallel import TrainState, distributed, make_eval_step, put_batch
from pointmvsnet_tpu_torch.utils import orbax_reader
from pointmvsnet_tpu_torch.utils.checkpoint import Checkpointer
from pointmvsnet_tpu_torch.utils.convert import init_params
from pointmvsnet_tpu_torch.utils.eval_file_logger import eval_file_logger
from pointmvsnet_tpu_torch.utils.logger import setup_logger
from pointmvsnet_tpu_torch.utils.metric_logger import MetricLogger, global_summary
from pointmvsnet_tpu_torch.utils.solver import build_optimizer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Point-MVSNet evaluation (PyTorch port)")
    p.add_argument("--cfg", default="", help="config YAML path (needs PyYAML)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="dotted-path config overrides, e.g. TEST.WEIGHT out/checkpoints")
    return p.parse_args(argv)


def test(cfg, output_dir: str, max_batches: Optional[int] = None, device="cuda"):
    """Export every item of the test split. → (summary, depth dir): the
    meters' averages (losses and metrics where there is GT), ``maps``,
    ``maps_per_s`` (host clock over the loop, loading included) and
    ``maps_per_s_after_first`` (the same without the first batch, which
    also pays the first decode of its views and the kernels' warm-up;
    NaN for a loop of one batch)."""
    for key in ("BAND", "VIEW"):
        if cfg.PARALLEL[key] > 1:
            raise NotImplementedError(
                f"PARALLEL.{key}={cfg.PARALLEL[key]}: band- and view-parallel eval are "
                f"not ported (ROADMAP queue 1); the port splits whole items over the "
                f"ranks of a torchrun launch (PARALLEL.DATA)")
    dev = resolve_device(device)
    disable_tf32()
    distributed.init_data_parallel(cfg.PARALLEL.DATA, dev)
    logger = setup_logger("pointmvsnet_tpu_torch.test", output_dir)
    model = build_model(cfg, dev)
    loader = build_data_loader(cfg, "test")
    kwargs = dict(
        is_flow=cfg.MODEL.NAME != "mvsnet",
        img_scales=tuple(cfg.MODEL.TEST.IMG_SCALES),
        inter_scales=tuple(cfg.MODEL.TEST.INTER_SCALES),
        num_virtual_plane=cfg.DATA.TEST.NUM_VIRTUAL_PLANE,
    )
    state = TrainState(model, build_optimizer(cfg, dict(model.named_parameters())))
    checkpointer = Checkpointer(os.path.join(output_dir, "checkpoints"))
    if cfg.TEST.WEIGHT or checkpointer.latest_epoch() is not None:
        state, _ = checkpointer.load(state, resume=True, path=cfg.TEST.WEIGHT)
        kind = ("an orbax checkpoint of the JAX package"
                if cfg.TEST.WEIGHT and orbax_reader.is_orbax(cfg.TEST.WEIGHT) else ".pt")
        logger.info("weights: %s (%s)", cfg.TEST.WEIGHT or checkpointer.directory, kind)
    else:
        model.load_state_dict(init_params(model, torch.Generator().manual_seed(cfg.RNG_SEED)))
        logger.info("weights: none given, drawn from RNG_SEED=%d", cfg.RNG_SEED)

    eval_step = make_eval_step(build_loss_fn(cfg), pointmvsnet_metrics, kwargs, sharded=False)
    meters = MetricLogger()
    depth_dir = os.path.join(output_dir, "depths")
    os.makedirs(depth_dir, exist_ok=True)

    n_maps = n_first = 0
    t_start = t_first = time.time()
    for it, batch in enumerate(loader):
        if max_batches and it >= max_batches:
            break
        preds, losses, metrics = eval_step(state, put_batch(batch, dev))
        preds = {k: v.float().cpu().numpy() for k, v in preds.items()}
        for b in range(batch["images"].shape[0]):
            eval_file_logger(batch, preds, depth_dir, batch_index=b)
            n_maps += 1
        meters.update(**{k: float(v) for k, v in losses.items()},
                      **{k: float(v) for k, v in metrics.items()})
        if it == 0:
            n_first, t_first = n_maps, time.time()
        if it % cfg.TEST.LOG_PERIOD == 0:
            logger.info("test iter %d/%d  %s", it, len(loader), meters)
    t_end = time.time()
    # every rank's maps over the slowest rank's time
    counts = distributed.all_gather_object((n_maps, n_first, t_end - t_start, t_end - t_first))
    n_maps, n_first = sum(c[0] for c in counts), sum(c[1] for c in counts)
    elapsed, after = max(c[2] for c in counts), max(c[3] for c in counts)
    after_first = (n_maps - n_first) / after if n_maps > n_first else float("nan")
    if n_maps:
        logger.info("exported %d depth maps in %.1fs (%.3f maps/s; %.3f after the first batch)",
                    n_maps, elapsed, n_maps / elapsed, after_first)
    checkpointer.close()
    return dict(global_summary(meters), maps=n_maps, maps_per_s=n_maps / elapsed,
                maps_per_s_after_first=after_first), depth_dir


def main(argv=None):
    args = parse_args(argv)
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
    logger.info("config %s, overrides %s, device %s", args.cfg or "(defaults)", args.opts,
                args.device)
    return test(cfg, output_dir, device=args.device)


if __name__ == "__main__":
    main()
