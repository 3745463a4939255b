"""Training of the port: schedules, state and SGD, the train/eval steps
(with the focal-loss kernels on the card), the epoch loop and ``fit``, and
checkpointing."""
from .checkpoint import (
    CheckpointManager,
    is_committed,
    latest_checkpoint,
    read_commit_meta,
    restore_checkpoint,
    restore_latest,
    save_checkpoint,
)
from .loop import eval_epoch, fit, train_epoch
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
    "CheckpointManager",
    "ScheduledSGD",
    "TrainState",
    "create_train_state",
    "cyclic_swa_schedule",
    "eval_epoch",
    "fit",
    "is_committed",
    "large_batch_schedule",
    "latest_checkpoint",
    "load_carried_state",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "normalize_images",
    "read_commit_meta",
    "restore_checkpoint",
    "restore_latest",
    "save_checkpoint",
    "start_swa",
    "step_decay_schedule",
    "swap_swa_params",
    "train_epoch",
    "update_swa",
]
