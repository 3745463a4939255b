from .meters import AverageMeter, StepTimer

__all__ = ["AverageMeter", "StepTimer"]
