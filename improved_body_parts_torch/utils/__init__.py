from .meters import AverageMeter, PercentileMeter, StepTimer
from .profiling import chained_time, profile_trace, timed

__all__ = ["AverageMeter", "PercentileMeter", "StepTimer",
           "chained_time", "profile_trace", "timed"]
