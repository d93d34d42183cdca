"""The rank processes of tests/test_torch_distributed.py: ``run`` is spawned
by ``torch.multiprocessing`` once per rank, joins a gloo group over a
``FileStore`` (no network) and runs the jobs it is given, each on this
rank's part of the work; rank r writes its results to ``rank<r>.pt``.
Imports torch and the port only, so a rank starts in seconds."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def tiny_cfg(dtype: str, norm: str = "bn"):
    from pointmvsnet_tpu_torch.config import get_default_cfg
    cfg = get_default_cfg()
    cfg.MODEL.IMG_BASE_CHANNELS = 4
    cfg.MODEL.VOL_BASE_CHANNELS = 4
    cfg.MODEL.EDGE_CHANNELS = (8,)
    cfg.MODEL.FLOW_CHANNELS = (8, 1)
    cfg.MODEL.KNN = 8
    cfg.MODEL.NUM_VIRTUAL_PLANE = 16
    cfg.MODEL.MASKED_LOSS = False          # every flow pixel in the loss
    cfg.MODEL.NORM = norm
    cfg.MODEL.DTYPE = dtype
    return cfg


def train_cfg(opts: list):
    """``tiny_cfg`` in f32 with the dotted overrides ``opts`` (a CfgNode
    does not pickle, a list does)."""
    cfg = tiny_cfg("float32")
    cfg.merge_from_list(opts)
    return cfg


def train_step(dtype: str, kw: dict, flat: dict, batch: dict, knn_points=None):
    """One train step of the port on ``batch`` (this rank's rows), its kNN
    fed ``knn_points`` (the same rows) → losses, gradients, BN statistics."""
    import pointmvsnet_tpu_torch.models.pointmvsnet as tpointmvsnet
    from pointmvsnet_tpu_torch.models import build_loss_fn, build_model
    from pointmvsnet_tpu_torch.parallel import TrainState, make_train_step
    from pointmvsnet_tpu_torch.utils.convert import load_jax_variables
    from pointmvsnet_tpu_torch.utils.solver import build_optimizer

    cfg = tiny_cfg(dtype)
    model = build_model(cfg, "cpu")
    load_jax_variables(model, flat)
    state = TrainState(model, build_optimizer(cfg, dict(model.named_parameters())))
    orig = tpointmvsnet.window_knn_idx
    if knn_points is not None:
        tpointmvsnet.window_knn_idx = lambda pts, *args: orig(torch.from_numpy(knn_points), *args)
    try:
        state, losses = make_train_step(build_loss_fn(cfg), kw)(
            state, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()})
    finally:
        tpointmvsnet.window_knn_idx = orig
    return dict(losses={k: float(v) for k, v in losses.items()},
                grads={n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                       for n, p in model.named_parameters()},
                stats={n: b.clone() for n, b in model.named_buffers() if "running" in n},
                applied=state.optimizer.count)


def rows(x, rank: int, world: int):
    per = x.shape[0] // world
    return x[rank * per:(rank + 1) * per]


def run_job(rank: int, world: int, job: dict):
    kind = job["kind"]
    if kind == "step":
        batch = {k: rows(v, rank, world) for k, v in job["batch"].items()}
        points = job["knn_points"]
        return train_step(job["dtype"], job["kw"], job["flat"], batch,
                          None if points is None else rows(points, rank, world))
    if kind == "export":
        from pointmvsnet_tpu_torch import test
        summary, depth_dir = test.main(["--device", "cpu"] + job["opts"])
        return dict(summary=summary, depth_dir=depth_dir)
    if kind == "train":
        from pointmvsnet_tpu_torch.train import train
        state = train(train_cfg(job["opts"]), job["out"], max_steps_per_epoch=job["steps"],
                      device="cpu")
        return dict(step=state.step, skipped=state.optimizer.skipped_steps,
                    params={n: p.detach().clone() for n, p in state.model.named_parameters()},
                    buffers={n: b.clone() for n, b in state.model.named_buffers()})
    if kind == "raises":
        from pointmvsnet_tpu_torch.train import train
        try:
            train(train_cfg(job["opts"]), job["out"], device="cpu")
        except ValueError as e:
            return f"ValueError: {e}"
        return "no error"
    raise ValueError(f"unknown job {kind!r}")


def run(rank: int, world: int, store_file: str, jobs: list, out_dir: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world)
    try:
        results = [run_job(rank, world, job) for job in jobs]
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(jobs: list, work: str, world: int = 2) -> list:
    """Run ``jobs`` on ``world`` spawned ranks → [rank 0's results, ...]."""
    import torch.multiprocessing as mp
    os.makedirs(work, exist_ok=True)
    mp.spawn(run, args=(world, os.path.join(work, "store"), jobs, work), nprocs=world,
             join=True)
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
