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
"""

from __future__ import annotations

import os
from typing import Any, List

import torch
import torch.distributed as dist


def active() -> bool:
    """True inside a process group (of any size, one included)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def init_data_parallel(data: int, device: torch.device) -> int:
    """Check ``PARALLEL.DATA`` against the launch and start the process
    group if the launch has more than one process. → the world size."""
    world = dist.get_world_size() if active() else int(os.environ.get("WORLD_SIZE", "1"))
    if data not in (-1, world):
        raise ValueError(f"PARALLEL.DATA={data}, but the launch has {world} process(es): "
                         f"give -1 or {world} (one process per card, e.g. torchrun "
                         f"--nproc_per_node={data if data > 0 else 'N'})")
    if world > 1 and not active():
        cuda = device.type == "cuda"
        dist.init_process_group("nccl" if cuda else "gloo", init_method="env://",
                                device_id=device if cuda else None)
    return world


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks, whose backward is the sum over the ranks of the
    incoming gradients: each rank's loss is its part of the global loss."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the ranks, differentiable; ``t`` itself is left
    alone."""
    return _AllReduceSum.apply(t) if active() else t


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """In-place sum over the ranks, not differentiable (gradients, counts,
    reported losses)."""
    if active():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


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
