"""Host input pipeline of the port: NumPy/cv2 copies of the JAX package's
augmentation and GT synthesis, the HDF5 and in-memory datasets, the
shared-memory worker ring and the synthetic fixture."""
from .dataset import (
    CocoPoseDataset,
    MemoryDataset,
    batches,
    convert_joints,
    open_corpus,
)
from .heatmapper import Heatmapper
from .shm_ring import ShmRingInput, WorkerDied, batch_wire_format
from .transformer import IMAGE_NORM_SCALE, AugmentParams, Transformer

__all__ = [
    "AugmentParams",
    "CocoPoseDataset",
    "Heatmapper",
    "MemoryDataset",
    "IMAGE_NORM_SCALE",
    "ShmRingInput",
    "Transformer",
    "WorkerDied",
    "batch_wire_format",
    "batches",
    "convert_joints",
    "open_corpus",
]
