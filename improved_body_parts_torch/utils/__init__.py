from .meters import AverageMeter, PercentileMeter, StepTimer

__all__ = ["AverageMeter", "PercentileMeter", "StepTimer"]
