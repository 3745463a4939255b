"""Host→device input placement of the port (``device_prefetch``); the
mesh and partitioning of the JAX package's ``parallel`` are not ported."""
from .prefetch import device_prefetch

__all__ = ["device_prefetch"]
