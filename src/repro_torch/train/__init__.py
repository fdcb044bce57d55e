from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.optimizer import (
    OptConfig, adamw_update, init_opt_state, schedule,
)
from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step

__all__ = [
    "Checkpointer", "OptConfig", "adamw_update", "init_opt_state", "schedule",
    "Trainer", "TrainerConfig", "make_train_step",
]
