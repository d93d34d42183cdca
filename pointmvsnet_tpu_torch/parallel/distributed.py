"""Data parallelism over ``torch.distributed``: counterpart of
``pointmvsnet_tpu/parallel/mesh.py`` (the 1-D "data" mesh).

A run is launched with one process per card
(``torchrun --nproc_per_node=N -m pointmvsnet_tpu_torch.train``);
``init_data_parallel`` starts the process group from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): NCCL on the card, gloo on the CPU. A group the caller
started already is used as it is. One process starts no group, and every
helper below is then the identity, so a run without a group does exactly
the arithmetic of one with a group of one.

``PARALLEL.DATA`` keeps the JAX package's meaning: -1 is every process
of the launch, N must equal the launch's world size. The batch is the
global batch (``TRAIN.BATCH_SIZE``); each rank holds rows
``[r·b/W, (r+1)·b/W)`` of it (``dataset/build.py``). Parameters and
optimizer state are replicated; gradients are sum-all-reduced
(``parallel/train_step.py``) after a loss whose masked means divide by the
global count (``models/loss.py``), and train-mode BatchNorm reduces its
moments over the global batch (``models/blocks.py``), as flax's BatchNorm
does under the JAX package's sharded jit.

Eval runs on a process grid, the counterpart of ``make_mesh_eval``'s
("data", "band", "view") mesh: ``make_eval_grid`` lays the launch's
``data × band × view`` ranks out row-major and gives each rank the groups
of its band and view axes (``EvalGrid``). The band group shares out the
flow's row bands of one map (``models/pointmvsnet.py::banded_point_flow``),
the view group the cost volume's views (``parallel/view_parallel.py``);
ranks of one band and view group see the same items.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def active() -> bool:
    """True inside a process group (of any size, one included)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def init_data_parallel(data: int, device: torch.device, band: int = 1, view: int = 1) -> int:
    """Check ``PARALLEL.DATA`` against the launch, whose ranks form a
    ``data × band × view`` grid, and start the process group if the launch
    has more than one process. → the world size."""
    world = dist.get_world_size() if active() else int(os.environ.get("WORLD_SIZE", "1"))
    per = band * view
    if world % per:
        raise ValueError(f"PARALLEL.BAND={band} x PARALLEL.VIEW={view} needs a multiple of "
                         f"{per} processes, but the launch has {world}")
    if data not in (-1, world // per):
        raise ValueError(f"PARALLEL.DATA={data}, but the launch has {world} process(es) "
                         f"for {per} per data index: give -1 or {world // per} (one process "
                         f"per card, e.g. torchrun --nproc_per_node="
                         f"{data * per if data > 0 else 'N'})")
    if world > 1 and not active():
        cuda = device.type == "cuda"
        dist.init_process_group("nccl" if cuda else "gloo", init_method="env://",
                                device_id=device if cuda else None)
    return world


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks, whose backward is the sum over the ranks of the
    incoming gradients: each rank's loss is its part of the global loss."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``t`` over the ranks of ``group`` (default: all), differentiable;
    ``t`` itself is left alone."""
    return _AllReduceSum.apply(t, group) if active() else t


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over the ranks of ``group`` (default: all), not
    differentiable (gradients, counts, reported losses)."""
    if active():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` of every rank of ``group`` (each the same shape), concatenated
    along dim 0 in the group's rank order. gloo gathers on the host."""
    host = t.is_cuda and dist.get_backend(group) == "gloo"
    src = t.cpu() if host else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def all_gather_object(obj: Any) -> List[Any]:
    """``obj`` of every rank, in rank order (``[obj]`` without a group)."""
    if not active():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    if active():
        dist.barrier()


def assert_replicated(module: torch.nn.Module) -> None:
    """Raise on every rank unless ``module``'s parameters and buffers are
    bit-equal to rank 0's (each rank builds them from ``RNG_SEED``)."""
    if not active():
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in module.state_dict().values()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    bad = torch.tensor([0.0 if torch.equal(flat, ref) else 1.0], device=flat.device)
    all_reduce_sum_(bad)
    if bad.item():
        raise RuntimeError(f"the model's parameters differ from rank 0's on "
                           f"{int(bad.item())} rank(s)")


@dataclass(frozen=True)
class EvalGrid:
    """This rank's place in the eval grid: the axis sizes, its (data, band,
    view) index, and the groups of its axes. A group is None where its
    axis has size 1; ``data_group`` is also None where it is the whole
    launch (band = view = 1)."""
    data: int = 1
    band: int = 1
    view: int = 1
    index: Tuple[int, int, int] = (0, 0, 0)
    band_group: Optional[Any] = None
    view_group: Optional[Any] = None
    data_group: Optional[Any] = None

    @property
    def lead(self) -> bool:
        """The rank that reports for its band and view group (band 0, view 0)."""
        return self.index[1] == 0 and self.index[2] == 0


def make_eval_grid(data: int = -1, band: int = 1, view: int = 1,
                   device="cuda") -> EvalGrid:
    """The ("data", "band", "view") grid over the launch's ranks, laid out
    row-major as ``np.asarray(devices).reshape(data, band, view)``: rank
    ``(d·band + b)·view + v``. Checks the sizes and starts the process
    group (``init_data_parallel``: NCCL on the card, gloo on the CPU), then
    creates every band, view and data group on every rank in the same
    order, as ``dist.new_group`` requires. ``data`` -1 is every index the
    launch has room for; size-1 axes are legal."""
    band, view = max(1, band), max(1, view)
    world = init_data_parallel(data, torch.device(device), band, view)
    data = world // (band * view)
    if world == 1:
        return EvalGrid()
    at = np.arange(world).reshape(data, band, view)
    rank_ = dist.get_rank()
    index = tuple(int(i) for i in np.unravel_index(rank_, at.shape))
    groups = {}
    for name, used, lines in (("band_group", band > 1, at.transpose(0, 2, 1).reshape(-1, band)),
                              ("view_group", view > 1, at.reshape(-1, view)),
                              ("data_group", band * view > 1, at.reshape(data, -1).T)):
        for ranks in lines.tolist() if used else ():
            group = dist.new_group(ranks)
            if rank_ in ranks:
                groups[name] = group
    return EvalGrid(data, band, view, index, **groups)
