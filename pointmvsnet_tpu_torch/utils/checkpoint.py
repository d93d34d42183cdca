"""Checkpoint save / load with auto-resume: counterpart of
``pointmvsnet_tpu/utils/checkpoint.py`` on ``torch.save`` instead of orbax.

One file per epoch, ``<directory>/<epoch>.pt``, holding the model's
state_dict (parameters and BatchNorm statistics), the optimizer's state,
the step counter and the epoch; the newest ``MAX_TO_KEEP`` are kept.
``load(..., path=)`` reads a given checkpoint instead (the test CLI's
``TEST.WEIGHT``): a ``.pt`` file, or a directory whose newest
``<epoch>.pt`` is taken; a file may hold only ``{"model": state_dict}``.
The JAX package's orbax checkpoints are not read here (ROADMAP queue 1).
Under data parallelism rank 0 writes (the state is replicated) and every
rank reads the same file.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import torch

from pointmvsnet_tpu_torch.parallel import distributed
from pointmvsnet_tpu_torch.parallel.train_step import TrainState

MAX_TO_KEEP = 5


class Checkpointer:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _epochs(self) -> List[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := re.fullmatch(r"(\d+)\.pt", f)))

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
            for old in self._epochs()[:-MAX_TO_KEEP]:
                os.remove(self.path(old))
        distributed.barrier()

    def latest_epoch(self) -> Optional[int]:
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def load(self, state: TrainState, resume: bool = True,
             path: str = "") -> Tuple[TrainState, int]:
        """→ (state, next epoch). ``path`` (``TEST.WEIGHT``) overrides
        auto-resume: a ``.pt`` file or a directory of ``<epoch>.pt``
        files (the newest is taken); the optimizer and step are restored
        only if the file has them, and the next epoch is 0. Otherwise the
        newest checkpoint of this directory when ``resume`` and there is
        one."""
        if path:
            if os.path.isdir(path):
                epochs = Checkpointer(path)._epochs()
                if not epochs:
                    raise FileNotFoundError(f"no <epoch>.pt checkpoint in {path!r}")
                path = os.path.join(path, f"{epochs[-1]}.pt")
            return self._restore(state, path), 0
        last = self.latest_epoch() if resume else None
        if last is None:
            return state, 0
        return self._restore(state, self.path(last)), last + 1

    @staticmethod
    def _restore(state: TrainState, path: str) -> TrainState:
        device = next(state.model.parameters()).device
        ckpt = torch.load(path, map_location=device, weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        if "optimizer" in ckpt:
            state.optimizer.load_state_dict(ckpt["optimizer"])
        if "step" in ckpt:
            state.step = int(ckpt["step"])
        return state

    def close(self) -> None:
        """Nothing is pending: ``save`` writes synchronously."""
