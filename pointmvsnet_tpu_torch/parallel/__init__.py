"""Train / eval steps and data parallelism over ``torch.distributed``."""

from pointmvsnet_tpu_torch.parallel import distributed
from pointmvsnet_tpu_torch.parallel.train_step import (
    TrainState,
    make_eval_step,
    make_train_step,
    put_batch,
)

__all__ = ["TrainState", "make_train_step", "make_eval_step", "put_batch", "distributed"]
