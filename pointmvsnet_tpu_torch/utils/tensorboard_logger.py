"""TensorBoard scalar logging: the port's copy of
``pointmvsnet_tpu/utils/tensorboard_logger.py``. A no-op where tensorboardX
is not installed, as in the JAX package, and on every rank but rank 0
under data parallelism."""

from __future__ import annotations

from typing import Dict

from pointmvsnet_tpu_torch.parallel import distributed


class TensorboardLogger:
    def __init__(self, log_dir: str):
        self._writer = None
        if distributed.rank() != 0:
            return
        try:
            from tensorboardX import SummaryWriter
        except ImportError:  # pragma: no cover
            return
        self._writer = SummaryWriter(log_dir)

    def add_scalars(self, tag_values: Dict[str, float], step: int,
                    prefix: str = "") -> None:
        if self._writer is None:
            return
        for tag, value in tag_values.items():
            self._writer.add_scalar(f"{prefix}{tag}", float(value), step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
