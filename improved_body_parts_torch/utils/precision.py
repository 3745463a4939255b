"""Serve-time weight storage (the port's counterpart of
``improved_body_parts_tpu/utils/precision.py``).

Three tiers:

- **fp32**: the training dtype.
- **bf16**: every floating parameter and buffer cast to bf16
  (:func:`bf16_params`), BN running stats included, as the JAX package
  casts every fp32 leaf, ``batch_stats`` included.  The model's forward
  casts its input to the parameters' type, so it computes in bf16, as
  every config's ``bf16_compute`` does.
- **int8**: weight-only (:func:`quantize_int8`).  Every float32 parameter
  with at least 2 dims -- the conv and dense weights -- becomes int8
  values with per-output-channel fp32 scales, symmetric absmax / 127 over
  every axis but the output one, a zero channel getting scale 1.  Flax's
  output axis is the last (HWIO, and (in, out) for a dense layer);
  torch's is the first (OIHW, (out, in)), so the scales reduce over every
  axis but 0, and the values and scales equal the JAX package's after the
  layout change (``torch.round`` rounds half to even, as ``jnp.round``
  does).  Biases, norm parameters and running stats stay fp32.  The model
  keeps the int8 weights and the scales on the device and dequantizes
  each weight inside its layer's forward, at each call
  (:class:`Int8Layer`, the per-layer counterpart of the JAX package's
  ``DequantizingModel``), so the stored weights take a quarter of their
  fp32 bytes.

:func:`apply_serve_dtype` is the one construction site: the serve
artifacts and the evaluate CLI build their models through it.  The
functions change the model in place and return it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def resolve_params_dtype(mode: str, model: nn.Module) -> nn.Module:
    """Apply an inference storage policy: ``"fp32"`` leaves the model
    alone, ``"bf16"`` casts it (:func:`bf16_params`), ``"auto"`` (the
    inference CLIs' default) is bf16 on a CUDA device and fp32 on the CPU,
    which has no fast bf16 convolution."""
    if mode not in ("auto", "bf16", "fp32"):
        raise ValueError(f"params dtype mode {mode!r} not in auto/bf16/fp32")
    if mode == "fp32" or (mode == "auto"
                          and next(model.parameters()).device.type != "cuda"):
        return model
    return bf16_params(model)


def bf16_params(model: nn.Module) -> nn.Module:
    """Cast every floating parameter and buffer to bf16 (inference-time
    storage; training keeps fp32)."""
    return model.to(torch.bfloat16)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, fp32 scales (out,)) of a float32 weight whose output
    axis is axis 0: absmax / 127 over every other axis, scale 1 where a
    channel is all zeros, values rounded half to even and clipped to
    [-127, 127]."""
    absmax = w.abs().amax(dim=tuple(range(1, w.dim())))
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale.view(-1, *[1] * (w.dim() - 1))),
                    -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The float32 weight of int8 values ``q`` and their scales."""
    return q.to(torch.float32) * scale.view(-1, *[1] * (q.dim() - 1))


class Int8Layer(nn.Module):
    """A conv or dense layer whose weight is stored as int8 values and
    per-output-channel fp32 scales (buffers ``weight_q`` and
    ``weight_scale``) and dequantized at each call, inside the forward;
    the bias stays a float parameter.  The wrapped layer keeps its
    geometry (stride, padding, dilation) and holds no tensor."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        if not isinstance(layer, (nn.Conv2d, nn.Linear)):
            raise TypeError(f"int8 storage covers Conv2d and Linear, not "
                            f"{type(layer).__name__}")
        q, scale = quantize_weight(layer.weight.detach())
        self.register_buffer("weight_q", q)
        self.register_buffer("weight_scale", scale)
        self.bias = layer.bias
        del layer.weight
        layer.bias = None
        self.layer = layer

    def dequantized(self) -> torch.Tensor:
        return dequantize_weight(self.weight_q, self.weight_scale)

    def forward(self, x):
        w = self.dequantized()
        if isinstance(self.layer, nn.Linear):
            return F.linear(x, w, self.bias)
        return self.layer._conv_forward(x, w, self.bias)


def _replace_layers(model: nn.Module, make) -> nn.Module:
    """Replace every child ``c`` of every module by ``make(c)`` where that
    is not None."""
    for module in list(model.modules()):
        for name, child in list(module.named_children()):
            new = make(child)
            if new is not None:
                setattr(module, name, new)
    return model


def quantize_int8(model: nn.Module) -> nn.Module:
    """Weight-only int8 storage: every Conv2d and Linear with a float32
    weight becomes an :class:`Int8Layer`.  Raises if any float32
    parameter with at least 2 dims is left outside such a layer (the
    policy quantizes all of them)."""
    _replace_layers(model, lambda c: Int8Layer(c) if isinstance(
        c, (nn.Conv2d, nn.Linear)) and c.weight.dtype == torch.float32
        else None)
    left = [n for n, p in model.named_parameters()
            if p.dtype == torch.float32 and p.dim() >= 2]
    if left:
        raise ValueError(f"float32 weights outside a conv or dense layer "
                         f"are not quantized: {left[:4]}")
    return model


def dequantize_int8(model: nn.Module) -> nn.Module:
    """Inverse of :func:`quantize_int8`: every :class:`Int8Layer` back to
    its plain layer with the dequantized float32 weight."""
    def restore(child):
        if not isinstance(child, Int8Layer):
            return None
        layer = child.layer
        layer.weight = nn.Parameter(child.dequantized())
        layer.bias = child.bias
        return layer
    return _replace_layers(model, restore)


def apply_serve_dtype(mode: str, model: nn.Module) -> nn.Module:
    """The single construction site for serve-time weight storage:
    ``mode`` is auto, bf16, fp32 or int8; ``"int8"`` quantizes
    (:func:`quantize_int8`), the others go through
    :func:`resolve_params_dtype`."""
    if mode == "int8":
        return quantize_int8(model)
    return resolve_params_dtype(mode, model)


def storage_bytes(model: nn.Module) -> int:
    """Bytes of the model's parameters and buffers, as stored."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))
