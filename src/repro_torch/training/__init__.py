"""Training: optimizers, the train step, checkpoints — the counterparts of
the reference's ``repro/training``."""
from repro_torch.training.optimizer import (make_adafactor, make_adamw,
                                            make_optimizer)
from repro_torch.training.train_step import (TrainHParams, init_train_state,
                                             int8_allreduce,
                                             make_optimizer_for,
                                             make_train_step)
from repro_torch.training import checkpoint

__all__ = [
    "TrainHParams",
    "checkpoint",
    "init_train_state",
    "int8_allreduce",
    "make_adafactor",
    "make_adamw",
    "make_optimizer",
    "make_optimizer_for",
    "make_train_step",
]
