"""Training of the port: schedules, state and SGD, the train/eval steps
(with the focal-loss kernels on the card) and the epoch loop."""
from .loop import eval_epoch, train_epoch
from .schedule import (
    cyclic_swa_schedule,
    large_batch_schedule,
    step_decay_schedule,
)
from .state import (
    ScheduledSGD,
    TrainState,
    create_train_state,
    load_carried_state,
    make_optimizer,
    start_swa,
    swap_swa_params,
    update_swa,
)
from .step import make_eval_step, make_train_step, normalize_images

__all__ = [
    "ScheduledSGD",
    "TrainState",
    "create_train_state",
    "cyclic_swa_schedule",
    "eval_epoch",
    "large_batch_schedule",
    "load_carried_state",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "normalize_images",
    "start_swa",
    "step_decay_schedule",
    "swap_swa_params",
    "train_epoch",
    "update_swa",
]
