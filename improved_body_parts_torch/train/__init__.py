"""Training of the port: schedules, state and SGD, the train/eval steps
(with the focal-loss kernels on the card; GT made on the device), heatmap
distillation, the epoch loop and ``fit``, checkpointing and the run
supervisor."""
from .checkpoint import (
    CheckpointManager,
    is_committed,
    latest_checkpoint,
    read_commit_meta,
    restore_checkpoint,
    restore_latest,
    save_checkpoint,
)
from .distill import bind_teacher, distill_alpha, make_distill_train_step
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
from .supervisor import (
    RunSupervisor,
    PartitionRulesChanged,
    StopRequested,
    SupervisorGaveUp,
    TopologyChanged,
    chaos_kill_point,
    classify_error,
    milestone_eval,
    reshard_on_topology_change,
)

__all__ = [
    "CheckpointManager",
    "PartitionRulesChanged",
    "RunSupervisor",
    "StopRequested",
    "SupervisorGaveUp",
    "TopologyChanged",
    "bind_teacher",
    "chaos_kill_point",
    "classify_error",
    "distill_alpha",
    "make_distill_train_step",
    "milestone_eval",
    "reshard_on_topology_change",
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
