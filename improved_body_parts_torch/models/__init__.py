from .convert import (
    flax_to_state_dict,
    flax_train_state_to_torch,
    load_flax_variables,
)
from .layers import (
    Backbone,
    BatchNorm,
    ConvBlock,
    Hourglass,
    Residual,
    SELayer,
    init_weights,
    max_pool_2x2,
    upsample_nearest_2x,
)
from .posenet import Features, PoseNet, build_model

__all__ = [
    "Backbone",
    "BatchNorm",
    "ConvBlock",
    "Features",
    "Hourglass",
    "PoseNet",
    "Residual",
    "SELayer",
    "build_model",
    "flax_to_state_dict",
    "flax_train_state_to_torch",
    "init_weights",
    "load_flax_variables",
    "max_pool_2x2",
    "upsample_nearest_2x",
]
