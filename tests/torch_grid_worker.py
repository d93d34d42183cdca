"""The rank processes of tests/test_torch_parallel_eval.py: ``start`` spawns
``world`` ranks once, each joins a gloo group over a ``FileStore`` (no
network) and runs every job it is given on the eval grid the job names
(``parallel/distributed.py::make_eval_grid`` over all ranks); rank r writes
its results to ``rank<r>.pt``, which ``finish`` collects. A job may wait
for kNN input points that the test process records meanwhile
(``load_pool``). Imports torch and the port only, so a rank starts in
seconds."""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist



def grid_cfg(norm: str, chunk_rows: int):
    """tests/test_parallel.py's ``tiny_cfg`` (D=8, base 4, EdgeConv (8,),
    head (8, 1), K=8) with the given norm and band height."""
    from pointmvsnet_tpu_torch.config import get_default_cfg
    cfg = get_default_cfg()
    cfg.MODEL.NUM_VIRTUAL_PLANE = 8
    cfg.MODEL.EDGE_CHANNELS = (8,)
    cfg.MODEL.FLOW_CHANNELS = (8, 1)
    cfg.MODEL.IMG_BASE_CHANNELS = 4
    cfg.MODEL.VOL_BASE_CHANNELS = 4
    cfg.MODEL.KNN = 8
    cfg.MODEL.NORM = norm
    cfg.MODEL.FLOW_CHUNK_ROWS = chunk_rows
    return cfg


@contextlib.contextmanager
def fed_knn(pool):
    """Inside the block the model's eval kNN takes, in place of its input
    points, the recorded points of ``pool`` (the JAX package's) nearest to
    them, so both packages build the same graph: kNN near-ties flip under
    f32 differences of ~1e-6 and move a depth by up to 1e-2."""
    import pointmvsnet_tpu_torch.models.pointmvsnet as mflow
    orig = mflow.window_knn_mask
    rows = [row for p in pool or () for row in p]           # one (G·N, 3) per batch row

    def nearest(q):
        gaps = [float(np.abs(p - q).max()) if p.shape == q.shape else np.inf for p in rows]
        best = int(np.argmin(gaps))
        if gaps[best] > 1e-3:
            raise AssertionError(f"no recorded kNN input near this one: {gaps}")
        return rows[best]

    def fed(pts, *args):
        return orig(torch.from_numpy(np.stack([nearest(q) for q in pts.numpy()])), *args)

    mflow.window_knn_mask = fed if pool is not None else orig
    try:
        yield
    finally:
        mflow.window_knn_mask = orig


def load_pool(job: dict, timeout: float = 900.0):
    """The job's recorded kNN input points: ``job["pool"]``, or entry
    ``job["pool_key"]`` of the file ``job["pool_file"]``, which the test
    process writes once the JAX package's runs have recorded them."""
    if "pool_file" not in job:
        return job.get("pool")
    path = job["pool_file"]
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written in {timeout:.0f} s")
        time.sleep(0.1)
    return torch.load(path, weights_only=False)[job["pool_key"]]


def forward(cfg, flat, images, cams, kw, grid=None, pool=None):
    """The port's eval forward from the JAX variables ``flat`` → numpy preds."""
    from pointmvsnet_tpu_torch.models import build_model
    from pointmvsnet_tpu_torch.utils.convert import load_jax_variables

    model = build_model(cfg, "cpu", grid)
    load_jax_variables(model, flat)
    with fed_knn(pool), torch.inference_mode():
        preds = model(torch.tensor(images), torch.tensor(cams), **kw)
    return {k: v.numpy() for k, v in preds.items()}


def predict(images, cams, grid=None):
    """``Predictor`` at tests/test_parallel.py's size (flows at 0.5 and
    0.625, FLOW_CHUNK_ROWS 8, weights from RNG_SEED) → its answer."""
    from pointmvsnet_tpu_torch.predictor import Predictor

    cfg = grid_cfg("bn", 8)
    cfg.MODEL.TEST.IMG_SCALES = (0.5, 0.625)
    cfg.MODEL.TEST.INTER_SCALES = (0.75, 0.375)
    cfg.DATA.TEST.NUM_VIRTUAL_PLANE = 8
    return Predictor(cfg, device="cpu", normalize=False, grid=grid)(images, cams)


def run_job(job: dict):
    from pointmvsnet_tpu_torch.parallel import distributed

    kind = job["kind"]
    if kind == "layout":
        out = {}
        for shape in job["shapes"]:
            grid = distributed.make_eval_grid(*shape, device="cpu")
            out[shape] = (grid.index, grid.lead, {
                name: None if getattr(grid, name) is None
                else dist.get_process_group_ranks(getattr(grid, name))
                for name in ("band_group", "view_group", "data_group")})
        return out
    if kind == "raises":
        try:
            run_job(job["job"])
        except ValueError as e:
            return f"ValueError: {e}"
        return "no error"
    grid = distributed.make_eval_grid(*job["grid"], device="cpu")
    if kind == "sweep":
        from pointmvsnet_tpu_torch.parallel.view_parallel import view_sharded_plane_sweep
        feats, cams, depths = (torch.from_numpy(job[k]) for k in ("feats", "cams", "depths"))
        return view_sharded_plane_sweep(feats, cams, cams[:, 0], depths, grid.view_group).numpy()
    if kind == "forward":
        return forward(grid_cfg(*job["cfg"]), job["flat"], job["images"], job["cams"],
                       job["kw"], grid, load_pool(job))
    if kind == "predict":
        return predict(job["images"], job["cams"], grid)
    if kind == "eval_step":
        from pointmvsnet_tpu_torch.models import build_loss_fn, build_model, pointmvsnet_metrics
        from pointmvsnet_tpu_torch.parallel import TrainState, make_eval_step
        from pointmvsnet_tpu_torch.utils.convert import load_jax_variables
        from pointmvsnet_tpu_torch.utils.solver import build_optimizer

        cfg = grid_cfg(*job["cfg"])
        model = build_model(cfg, "cpu", grid)
        load_jax_variables(model, job["flat"])
        state = TrainState(model, build_optimizer(cfg, dict(model.named_parameters())))
        per = job["batch"]["images"].shape[0] // grid.data
        rows = slice(grid.index[0] * per, (grid.index[0] + 1) * per)
        batch = {k: torch.from_numpy(v[rows]) for k, v in job["batch"].items()}
        with fed_knn(load_pool(job)):
            preds, losses, metrics = make_eval_step(build_loss_fn(cfg), pointmvsnet_metrics,
                                                    job["kw"], grid=grid)(state, batch)
        return dict(preds={k: v.numpy() for k, v in preds.items()},
                    losses={k: float(v) for k, v in losses.items()},
                    metrics={k: float(v) for k, v in metrics.items()})
    raise ValueError(f"unknown job {kind!r}")


def run(rank: int, world: int, store_file: str, jobs_file: str, out_dir: str) -> None:
    jobs = torch.load(jobs_file, weights_only=False)
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world)
    try:
        results = []
        for job in jobs:
            if job["kind"] == "export":
                from pointmvsnet_tpu_torch import test
                results.append(test.main(["--device", "cpu"] + job["opts"]))
            else:
                results.append(run_job(job))
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start(jobs: list, work: str, world: int):
    """Start ``world`` ranks on ``jobs`` → the ``ProcessContext`` to ``finish``.
    The jobs go through a file: a start blocks until the child has read its
    arguments, which it does only after importing torch, so large arguments
    would start the ranks one after the other."""
    import torch.multiprocessing as mp
    os.makedirs(work, exist_ok=True)
    jobs_file = os.path.join(work, "jobs.pt")
    torch.save(jobs, jobs_file)
    return mp.spawn(run, args=(world, os.path.join(work, "store"), jobs_file, work),
                    nprocs=world, join=False)


def finish(ctx, work: str) -> list:
    """Wait for the ranks (raising what one raised) → [rank 0's results, ...]."""
    while not ctx.join():
        pass
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(len(ctx.processes))]
