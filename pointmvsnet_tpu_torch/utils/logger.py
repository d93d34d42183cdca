"""stdout + file logging: the port's copy of
``pointmvsnet_tpu/utils/logger.py``. Under data parallelism rank 0 logs;
the other ranks print warnings and errors only, and write no file."""

from __future__ import annotations

import logging
import os
import sys

from pointmvsnet_tpu_torch.parallel import distributed


def setup_logger(name: str = "pointmvsnet_tpu_torch", save_dir: str = "",
                 filename: str = "log.txt") -> logging.Logger:
    logger = logging.getLogger(name)
    lead = distributed.rank() == 0
    logger.setLevel(logging.INFO if lead else logging.WARNING)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if save_dir and lead:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, filename))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
