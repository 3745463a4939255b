from .configs import (
    COCO_PARTS,
    Config,
    ModelConfig,
    SkeletonConfig,
    TrainConfig,
    TransformParams,
    available_configs,
    get_config,
)
from .inference import (
    InferenceModelParams,
    InferenceParams,
    default_inference_params,
)

__all__ = [
    "COCO_PARTS",
    "Config",
    "ModelConfig",
    "SkeletonConfig",
    "TrainConfig",
    "TransformParams",
    "available_configs",
    "get_config",
    "InferenceModelParams",
    "InferenceParams",
    "default_inference_params",
]
