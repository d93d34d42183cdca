"""Checkpoint save / load with auto-resume: counterpart of
``pointmvsnet_tpu/utils/checkpoint.py`` on ``torch.save`` instead of orbax.

One file per epoch, ``<directory>/<epoch>.pt``, holding the model's
state_dict (parameters and BatchNorm statistics), the optimizer's state,
the step counter and the epoch; the newest ``MAX_TO_KEEP`` are kept.
``load(..., path=)`` reads a given checkpoint instead (the test CLI's
``TEST.WEIGHT``): a ``.pt`` file, or a directory whose newest
``<epoch>.pt`` is taken (a file may hold only ``{"model": state_dict}``),
or a checkpoint the JAX package's orbax ``Checkpointer`` wrote: a manager
root (its newest step), a step directory or an item directory. Of an
orbax checkpoint the parameters and BatchNorm statistics are read
(``utils/orbax_reader.py``, numpy only) and carried across by
``utils/convert.py::load_jax_variables``; the optimizer is left as it is.
The port's own saves stay ``.pt``. Under data parallelism rank 0 writes
(the state is replicated) and every rank reads the same file.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import torch

from pointmvsnet_tpu_torch.parallel import distributed
from pointmvsnet_tpu_torch.parallel.train_step import TrainState
from pointmvsnet_tpu_torch.utils import orbax_reader
from pointmvsnet_tpu_torch.utils.convert import load_jax_variables

MAX_TO_KEEP = 5


def _epochs(directory: str) -> List[int]:
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := re.fullmatch(r"(\d+)\.pt", f)))


def load_weights(model: torch.nn.Module, path: str) -> dict:
    """Load the weights at ``path`` into ``model``: an orbax checkpoint of
    the JAX package (``orbax_reader.is_orbax``), a directory of
    ``<epoch>.pt`` files (the newest), or a ``.pt`` file. → the rest of a
    ``.pt`` checkpoint (``optimizer``, ``step``, …); ``{}`` for orbax.
    Raises if ``path`` holds no checkpoint or misses any weight."""
    if orbax_reader.is_orbax(path):
        flat = orbax_reader.read_orbax(path, keys=("params/", "batch_stats/"))
        load_jax_variables(model, flat)
        return {}
    if os.path.isdir(path):
        epochs = _epochs(path)
        if not epochs:
            raise FileNotFoundError(f"no <epoch>.pt checkpoint and no orbax checkpoint in "
                                    f"{path!r}")
        path = os.path.join(path, f"{epochs[-1]}.pt")
    device = next(model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(ckpt.pop("model"))
    return ckpt


class Checkpointer:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"{epoch}.pt")

    def save(self, state: TrainState, epoch: int) -> None:
        """Write the state of the end of ``epoch`` (atomically, on rank 0),
        then drop all but the newest ``MAX_TO_KEEP`` files; every rank
        returns once the file is there."""
        if distributed.rank() == 0:
            tmp = self.path(epoch) + ".tmp"
            torch.save({"model": state.model.state_dict(),
                        "optimizer": state.optimizer.state_dict(),
                        "step": state.step, "epoch": epoch}, tmp)
            os.replace(tmp, self.path(epoch))
            for old in _epochs(self.directory)[:-MAX_TO_KEEP]:
                os.remove(self.path(old))
        distributed.barrier()

    def latest_epoch(self) -> Optional[int]:
        epochs = _epochs(self.directory)
        return epochs[-1] if epochs else None

    def load(self, state: TrainState, resume: bool = True,
             path: str = "") -> Tuple[TrainState, int]:
        """→ (state, next epoch). ``path`` (``TEST.WEIGHT``) overrides
        auto-resume: a ``.pt`` file, a directory of ``<epoch>.pt`` files
        (the newest is taken) or an orbax checkpoint (``load_weights``);
        the optimizer and step are restored only if a ``.pt`` file has
        them, and the next epoch is 0. Otherwise the newest checkpoint of
        this directory when ``resume`` and there is one."""
        if path:
            return self._restore(state, path), 0
        last = self.latest_epoch() if resume else None
        if last is None:
            return state, 0
        return self._restore(state, self.path(last)), last + 1

    @staticmethod
    def _restore(state: TrainState, path: str) -> TrainState:
        ckpt = load_weights(state.model, path)
        if "optimizer" in ckpt:
            state.optimizer.load_state_dict(ckpt["optimizer"])
        if "step" in ckpt:
            state.step = int(ckpt["step"])
        return state

    def close(self) -> None:
        """Nothing is pending: ``save`` writes synchronously."""
