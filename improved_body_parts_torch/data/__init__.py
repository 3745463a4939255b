"""Host input pipeline of the port: NumPy/cv2 copies of the JAX package's
augmentation and GT synthesis, the HDF5 dataset and the synthetic
fixture."""
from .dataset import CocoPoseDataset, batches, convert_joints
from .heatmapper import Heatmapper
from .transformer import IMAGE_NORM_SCALE, AugmentParams, Transformer

__all__ = [
    "AugmentParams",
    "CocoPoseDataset",
    "Heatmapper",
    "IMAGE_NORM_SCALE",
    "Transformer",
    "batches",
    "convert_joints",
]
