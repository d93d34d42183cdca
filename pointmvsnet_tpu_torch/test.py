"""Evaluation / depth-map export entry point: counterpart of
``pointmvsnet_tpu/test.py``.

    python -m pointmvsnet_tpu_torch.test [--cfg configs/dtu_wde3.yaml] \\
        [--device cuda|cpu] TEST.WEIGHT <ckpt.pt, dir or orbax dir> DATA.TEST.ROOT_DIR ...

No-grad loop over the test split (DTU or Tanks & Temples) at the eval
settings, per-batch losses and depth metrics where the split has GT
depth, and the MVSNet-format export that ``fuse.py`` reads
(``OUTPUT_DIR/depths/scan<n>/``). The model (``MODEL.NAME``: Point-MVSNet,
its coarse-only ``mvsnet``, or ``casmvsnet``) gives its eval options, its
crop base and the maps it exports; ``build_loss_fn`` / ``build_metric_fn``
its loss and metrics. The weights come from ``TEST.WEIGHT``
(a ``.pt`` file, a directory of ``<epoch>.pt`` files, or an orbax
checkpoint the JAX package wrote: its manager root, a step or an item
directory; ``utils/checkpoint.py::load_weights``), else from the newest
checkpoint under ``OUTPUT_DIR/checkpoints``, else from ``cfg.RNG_SEED``
(``utils.convert.init_params``, as ``Predictor``); the log names which.
A reference Point-MVSNet ``.pth`` is converted first
(``utils/torch_convert.py``).
Under torchrun the ranks form a ``PARALLEL.DATA × BAND × VIEW`` grid
(``parallel/distributed.py::make_eval_grid``; DATA -1 is the world size
over BAND·VIEW): the ranks of one band and view group share the flow
bands (``MODEL.FLOW_CHUNK_ROWS`` > 0) and the cost volume's views of each
map, the D data groups each take every D-th item of the split, with
``TEST.BATCH_SIZE`` items per batch, and the (band 0, view 0) rank of
each writes its maps into the one depth directory. The summary is over
those ranks' batches, per map.

    torchrun --nproc_per_node=4 -m pointmvsnet_tpu_torch.test PARALLEL.BAND 2 \
        PARALLEL.VIEW 2 MODEL.FLOW_CHUNK_ROWS 64 ...
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
from pointmvsnet_tpu_torch.models import build_loss_fn, build_metric_fn, build_model
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
    dev = resolve_device(device)
    disable_tf32()
    grid = distributed.make_eval_grid(cfg.PARALLEL.DATA, cfg.PARALLEL.BAND,
                                      cfg.PARALLEL.VIEW, dev)
    logger = setup_logger("pointmvsnet_tpu_torch.test", output_dir)
    model = build_model(cfg, dev, grid)
    loader = build_data_loader(cfg, "test", shard=(grid.index[0], grid.data),
                               base=model.crop_base)
    kwargs = model.eval_kwargs(cfg)
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

    eval_step = make_eval_step(build_loss_fn(cfg), build_metric_fn(cfg), kwargs, sharded=False)
    meters = MetricLogger()
    depth_dir = os.path.join(output_dir, "depths")
    os.makedirs(depth_dir, exist_ok=True)

    n_maps = n_first = 0
    t_start = t_first = time.time()
    for it, batch in enumerate(loader):
        if max_batches and it >= max_batches:
            break
        preds, losses, metrics = eval_step(state, put_batch(batch, dev))
        if grid.lead:            # the other ranks of its band and view group hold the same
            preds = {k: v.float().cpu().numpy() for k, v in preds.items()}
            maps = model.export_maps(preds)
            for b in range(batch["images"].shape[0]):
                eval_file_logger(batch, preds, depth_dir, batch_index=b, maps=maps)
                n_maps += 1
            meters.update(**{k: float(v) for k, v in losses.items()},
                          **{k: float(v) for k, v in metrics.items()})
        if it == 0:
            n_first, t_first = n_maps, time.time()
        if it % cfg.TEST.LOG_PERIOD == 0:
            logger.info("test iter %d/%d  %s", it, len(loader), meters)
    t_end = time.time()
    # every lead rank's maps over the slowest rank's time
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
    distributed.init_data_parallel(cfg.PARALLEL.DATA, resolve_device(args.device),
                                   max(1, cfg.PARALLEL.BAND), max(1, cfg.PARALLEL.VIEW))
    logger = setup_logger("pointmvsnet_tpu_torch", output_dir)
    logger.info("config %s, overrides %s, device %s", args.cfg or "(defaults)", args.opts,
                args.device)
    return test(cfg, output_dir, device=args.device)


if __name__ == "__main__":
    main()
