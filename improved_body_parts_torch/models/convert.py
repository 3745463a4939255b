"""Flax → PyTorch weight conversion for the IMHN ``PoseNet``.

Turns a Flax variables tree ``{"params": ..., "batch_stats": ...}`` of
numpy arrays (as ``improved_body_parts_tpu`` saves or initialises it) into
this package's ``state_dict`` — the inverse of
``tools/import_torch_checkpoint.py:30-35``:

- conv kernel (kh, kw, I, O) → weight (O, I, kh, kw);
- Dense kernel (I, O) → weight (O, I);
- BatchNorm scale/bias → weight/bias, batch_stats mean/var →
  running_mean/running_var.

Flax names submodules by class and creation order (``ConvBlock_3``,
``Residual_0``...); :func:`flax_leaf_map` spells out that order for each
module of :mod:`models.posenet`.  Conversion fails loudly on any Flax leaf
left unused, any model tensor left unfilled, or any shape mismatch.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .layers import Backbone, ConvBlock, Hourglass, Residual, SELayer
from .posenet import Features, PoseNet

# torch key -> (collection, flax path, transform)
LeafMap = Dict[str, Tuple[str, Tuple[str, ...], str]]


def _bn(out: LeafMap, tp: str, fp: Tuple[str, ...]):
    out[tp + "weight"] = ("params", fp + ("scale",), "copy")
    out[tp + "bias"] = ("params", fp + ("bias",), "copy")
    out[tp + "running_mean"] = ("batch_stats", fp + ("mean",), "copy")
    out[tp + "running_var"] = ("batch_stats", fp + ("var",), "copy")


def _conv(out: LeafMap, conv: nn.Conv2d, tp: str, fp: Tuple[str, ...]):
    out[tp + "weight"] = ("params", fp + ("kernel",), "conv")
    if conv.bias is not None:
        out[tp + "bias"] = ("params", fp + ("bias",), "copy")


def _conv_block(out, m: ConvBlock, tp, fp):
    _conv(out, m.conv, tp + "conv.", fp + ("Conv_0",))
    if m.bn is not None:
        _bn(out, tp + "bn.", fp + ("BatchNorm_0",))


def _residual(out, m: Residual, tp, fp):
    n = 4 if m.skip_conv is not None else 3
    names = [("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"),
             ("skip_conv", "skip_bn")][:n]
    for i, (c, b) in enumerate(names):
        _conv(out, getattr(m, c), f"{tp}{c}.", fp + (f"Conv_{i}",))
        _bn(out, f"{tp}{b}.", fp + (f"BatchNorm_{i}",))


def _se(out, m: SELayer, tp, fp):
    for i, name in enumerate(("fc1", "fc2")):
        out[f"{tp}{name}.weight"] = ("params", fp + (f"Dense_{i}", "kernel"),
                                     "dense")
        out[f"{tp}{name}.bias"] = ("params", fp + (f"Dense_{i}", "bias"),
                                   "copy")


def _backbone(out, m: Backbone, tp, fp):
    _conv_block(out, m.stem, tp + "stem.", fp + ("ConvBlock_0",))
    _residual(out, m.res1, tp + "res1.", fp + ("Residual_0",))
    _residual(out, m.res2, tp + "res2.", fp + ("Residual_1",))
    for i, cb in enumerate(m.dilated):
        _conv_block(out, cb, f"{tp}dilated.{i}.", fp + (f"ConvBlock_{i + 1}",))


def _hourglass(out, m: Hourglass, tp, fp):
    d = m.depth
    for i in range(d):
        _residual(out, m.skips[i], f"{tp}skips.{i}.",
                  fp + (f"Residual_{2 * i}",))
        _residual(out, m.downs[i], f"{tp}downs.{i}.",
                  fp + (f"Residual_{2 * i + 1}",))
    _residual(out, m.inner, tp + "inner.", fp + (f"Residual_{2 * d}",))
    for step in range(d):
        _residual(out, m.lows[step], f"{tp}lows.{step}.",
                  fp + (f"Residual_{2 * d + 1 + step}",))
        _conv_block(out, m.refines[step], f"{tp}refines.{step}.",
                    fp + (f"ConvBlock_{step}",))


def _features(out, m: Features, tp, fp):
    for j, head in enumerate(m.heads):
        _conv_block(out, head[0], f"{tp}heads.{j}.0.",
                    fp + (f"ConvBlock_{2 * j}",))
        _conv_block(out, head[1], f"{tp}heads.{j}.1.",
                    fp + (f"ConvBlock_{2 * j + 1}",))
        _se(out, head[2], f"{tp}heads.{j}.2.", fp + (f"SELayer_{j}",))


def flax_leaf_map(model: PoseNet) -> LeafMap:
    """Every tensor of ``model.state_dict()`` (bar BN's
    ``num_batches_tracked``) → where it lives in the Flax tree."""
    out: LeafMap = {}
    _backbone(out, model.backbone, "backbone.", ("Backbone_0",))
    block = 0  # PoseNet-scope ConvBlock counter, in Flax creation order
    for i in range(model.nstack):
        _hourglass(out, model.hourglasses[i], f"hourglasses.{i}.",
                   (f"Hourglass_{i}",))
        _features(out, model.features[i], f"features.{i}.",
                  (f"Features_{i}",))
        for j, head in enumerate(model.outs[i]):
            tp = f"outs.{i}.{j}."
            for name in ("pred", "merge_pred", "merge_feat"):
                sub = getattr(head, name)
                if sub is None:
                    continue
                _conv_block(out, sub, f"{tp}{name}.", (f"ConvBlock_{block}",))
                block += 1
    return out


def _flatten(tree: Mapping, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (str(k),)))
        else:
            flat[prefix + (str(k),)] = np.asarray(v)
    return flat


_TRANSFORMS = {
    "copy": lambda a: a,
    "conv": lambda a: np.transpose(a, (3, 2, 0, 1)),
    "dense": lambda a: a.T,
}


def flax_to_state_dict(variables: Mapping, model: PoseNet
                       ) -> Dict[str, torch.Tensor]:
    """Convert a Flax ``{"params", "batch_stats"}`` tree to ``model``'s
    state_dict.  Raises ``ValueError`` naming every unused Flax leaf,
    missing leaf or shape mismatch."""
    flat = {coll: _flatten(variables.get(coll, {}))
            for coll in ("params", "batch_stats")}
    extra = sorted(set(variables) - set(flat))
    leaf_map = flax_leaf_map(model)
    used = set()
    problems = [f"unexpected collection {c!r}" for c in extra]
    sd = {}
    for key, ref in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros_like(ref, device="cpu")
            continue
        if key not in leaf_map:
            problems.append(f"model tensor {key} has no Flax counterpart")
            continue
        coll, path, how = leaf_map[key]
        arr = flat[coll].get(path)
        if arr is None:
            problems.append(f"missing Flax leaf {coll}/{'/'.join(path)} "
                            f"for {key}")
            continue
        used.add((coll, path))
        val = np.array(_TRANSFORMS[how](arr), dtype=np.float32, order="C")
        if tuple(val.shape) != tuple(ref.shape):
            problems.append(f"{key}: shape {tuple(val.shape)} from "
                            f"{coll}/{'/'.join(path)} != {tuple(ref.shape)}")
            continue
        sd[key] = torch.from_numpy(val)
    for coll, leaves in flat.items():
        for path in sorted(set(leaves) - {p for c, p in used if c == coll}):
            problems.append(f"unused Flax leaf {coll}/{'/'.join(path)}")
    if problems:
        raise ValueError("Flax → torch conversion failed:\n  "
                         + "\n  ".join(problems))
    return sd


def load_flax_variables(model: PoseNet, variables: Mapping) -> PoseNet:
    """Load a Flax variables tree into ``model`` in place (strict)."""
    sd = flax_to_state_dict(variables, model)
    model.load_state_dict(sd, strict=True)
    return model


def _optax_states(opt_state):
    """Every optax state record (a NamedTuple) in ``opt_state``'s nested
    tuples, in chain order."""
    if hasattr(opt_state, "_fields"):
        yield opt_state
        children = tuple(opt_state)
    elif isinstance(opt_state, (tuple, list)):
        children = opt_state
    else:
        return
    for child in children:
        yield from _optax_states(child)


def flax_train_state_to_torch(train_state, model: PoseNet) -> Dict:
    """Turn a JAX ``TrainState`` (``improved_body_parts_tpu.train.state``:
    params, batch_stats, opt_state, step; read by attribute) into the
    port's training state, as numpy leaves:

    - ``"state_dict"``: ``model``'s state_dict (:func:`flax_to_state_dict`);
    - ``"momentum"``: {parameter name: SGD momentum buffer}, from the
      ``trace`` of optax's ``TraceState`` (converted like the parameter it
      belongs to);
    - ``"count"``: optax's ``ScaleByScheduleState.count``, the number of
      updates the schedule has counted;
    - ``"step"``: the global step.

    Raises ``ValueError`` when the optimizer state holds no momentum trace
    or no schedule count (``train.state.make_optimizer``'s chain has both).
    """
    traces = [s.trace for s in _optax_states(train_state.opt_state)
              if "trace" in s._fields]
    counts = [s.count for s in _optax_states(train_state.opt_state)
              if "count" in s._fields]
    if len(traces) != 1 or len(counts) != 1:
        raise ValueError(f"expected one momentum trace and one schedule "
                         f"count in opt_state, found {len(traces)} and "
                         f"{len(counts)}")
    variables = {"params": train_state.params,
                 "batch_stats": train_state.batch_stats}
    sd = {k: v.numpy() for k, v in flax_to_state_dict(variables,
                                                      model).items()}
    trace = _flatten(traces[0])
    leaf_map = flax_leaf_map(model)
    momentum = {}
    for name, p in model.named_parameters():
        _, path, how = leaf_map[name]
        val = np.array(_TRANSFORMS[how](trace[path]), dtype=np.float32,
                       order="C")
        if tuple(val.shape) != tuple(p.shape):
            raise ValueError(f"momentum of {name}: shape {val.shape} != "
                             f"{tuple(p.shape)}")
        momentum[name] = val
    return {"state_dict": sd, "momentum": momentum,
            "count": int(np.asarray(counts[0])),
            "step": int(np.asarray(train_state.step))}
