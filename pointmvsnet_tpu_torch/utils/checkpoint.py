"""Checkpoint save / load with auto-resume: counterpart of
``pointmvsnet_tpu/utils/checkpoint.py`` on ``torch.save`` instead of orbax.

One file per epoch, ``<directory>/<epoch>.pt``, holding the model's
state_dict (parameters and BatchNorm statistics), the optimizer's state,
the step counter and the epoch; the newest ``MAX_TO_KEEP`` are kept. The
JAX package's orbax checkpoints are not read here (ROADMAP queue 1), and
loading a given checkpoint for the test CLI (``TEST.WEIGHT``) waits for
that slice.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import torch

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
        """Write the state of the end of ``epoch`` (atomically), then drop
        all but the newest ``MAX_TO_KEEP`` files."""
        tmp = self.path(epoch) + ".tmp"
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step, "epoch": epoch}, tmp)
        os.replace(tmp, self.path(epoch))
        for old in self._epochs()[:-MAX_TO_KEEP]:
            os.remove(self.path(old))

    def latest_epoch(self) -> Optional[int]:
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def load(self, state: TrainState, resume: bool = True) -> Tuple[TrainState, int]:
        """Restore the newest checkpoint into ``state`` when ``resume``
        and there is one. → (state, next epoch)."""
        last = self.latest_epoch() if resume else None
        if last is None:
            return state, 0
        device = next(state.model.parameters()).device
        ckpt = torch.load(self.path(last), map_location=device, weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        return state, last + 1

    def close(self) -> None:
        """Nothing is pending: ``save`` writes synchronously."""
