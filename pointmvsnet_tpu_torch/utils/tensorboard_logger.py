"""TensorBoard scalar logging: the port's copy of
``pointmvsnet_tpu/utils/tensorboard_logger.py``. A no-op where tensorboardX
is not installed, as in the JAX package."""

from __future__ import annotations

from typing import Dict


class TensorboardLogger:
    def __init__(self, log_dir: str):
        try:
            from tensorboardX import SummaryWriter
            self._writer = SummaryWriter(log_dir)
        except ImportError:  # pragma: no cover
            self._writer = None

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
