from .meters import AverageMeter, PercentileMeter, StepTimer
from .profiling import chained_time, profile_trace, timed
from .visualize import (
    colorize_jet,
    module_dot,
    param_table,
    save_batch_overlays,
    train_batch_overlay,
)

__all__ = ["AverageMeter", "PercentileMeter", "StepTimer",
           "chained_time", "profile_trace", "timed",
           "colorize_jet", "module_dot", "param_table",
           "save_batch_overlays", "train_batch_overlay"]
