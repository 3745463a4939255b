from .convert import flax_to_state_dict, load_flax_variables
from .layers import (
    Backbone,
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
    "ConvBlock",
    "Features",
    "Hourglass",
    "PoseNet",
    "Residual",
    "SELayer",
    "build_model",
    "flax_to_state_dict",
    "init_weights",
    "load_flax_variables",
    "max_pool_2x2",
    "upsample_nearest_2x",
]
