"""Import an upstream SimplePose ``.pth`` into a checkpoint of the port
(counterpart of ``tools/import_torch_checkpoint.py``)::

    python -m improved_body_parts_torch.cli.import_torch_checkpoint \\
        --pth PoseNet_52_epoch.pth --out checkpoints/imported \\
        --config canonical

Upstream saves ``{'weights': state_dict, 'epoch', 'train_loss'}``
(train.py:149-162) from its ``PoseNet`` (models/posenet.py), e.g. the
published ``PoseNet_52_epoch.pth`` (config/config.py:23).  Upstream is
PyTorch too, so every tensor keeps its layout: the import renames keys.
The renaming composes two walks:

- upstream key → the JAX package's Flax path: this module's copy of the
  JAX tool's ``_Mapper`` walk (``tools/import_torch_checkpoint.py``,
  ``convert_posenet_state_dict``);
- Flax path → the port's key: ``models.convert.flax_leaf_map``.

DDP's ``module.`` and upstream's ``Network`` wrapper ``posenet.``
prefixes are stripped.  An upstream key that maps nowhere (BN's
``num_batches_tracked`` aside), a port tensor left unfilled or a shape
mismatch fails the import, naming each.  Only the variants ``imhn`` and
``imhn_independent`` share upstream's layout.  ``torch.load`` runs with
``weights_only=True`` (a downloaded file is untrusted input) unless
``--unsafe-load`` is given.

The result is ``<out>/epoch_<epoch>`` (``train.checkpoint``'s
``save_checkpoint``: the model state_dict, no optimizer state, the
payload's ``epoch`` and ``train_loss``), which ``cli.evaluate
--checkpoint`` and ``cli.demo --checkpoint`` load as they are.  The
state is loaded strictly into the model built on ``--device`` (``cuda``
unless asked for ``cpu``) before it is saved.
"""
from __future__ import annotations

import argparse
from typing import Dict, Mapping, Tuple

import torch

#: upstream key -> (Flax collection, Flax path)
UpstreamMap = Dict[str, Tuple[str, Tuple[str, ...]]]

VARIANTS = ("imhn", "imhn_independent")
PREFIXES = ("module.", "posenet.")


class _Walk:
    """The JAX tool's ``_Mapper`` walk over upstream's module names,
    recording where each upstream tensor lands in the Flax tree."""

    def __init__(self):
        self.map: UpstreamMap = {}

    @staticmethod
    def _path(fpath: str, *leaf: str) -> Tuple[str, ...]:
        return tuple(fpath.split("/")) + leaf

    def conv(self, tname: str, fpath: str, bias: bool = False):
        self.map[f"{tname}.weight"] = ("params", self._path(fpath, "kernel"))
        if bias:
            self.map[f"{tname}.bias"] = ("params", self._path(fpath, "bias"))

    def bn(self, tname: str, fpath: str):
        for tleaf, coll, fleaf in (("weight", "params", "scale"),
                                   ("bias", "params", "bias"),
                                   ("running_mean", "batch_stats", "mean"),
                                   ("running_var", "batch_stats", "var")):
            self.map[f"{tname}.{tleaf}"] = (coll, self._path(fpath, fleaf))

    def conv_block(self, tname: str, fpath: str):
        self.conv(f"{tname}.conv", f"{fpath}/Conv_0")
        self.bn(f"{tname}.bn", f"{fpath}/BatchNorm_0")

    def residual(self, tname: str, fpath: str):
        for i, (ci, bi) in enumerate([(0, 1), (3, 4), (6, 7)]):
            self.conv(f"{tname}.convBlock.{ci}", f"{fpath}/Conv_{i}")
            self.bn(f"{tname}.convBlock.{bi}", f"{fpath}/BatchNorm_{i}")
        # the skip conv exists where the block changes width; a model
        # without it drops these entries (:func:`upstream_key_map`)
        self.conv(f"{tname}.skipConv.0", f"{fpath}/Conv_3")
        self.bn(f"{tname}.skipConv.1", f"{fpath}/BatchNorm_3")

    def se(self, tname: str, fpath: str):
        for ti, fi in ((0, 0), (2, 1)):
            self.map[f"{tname}.fc.{ti}.weight"] = (
                "params", self._path(fpath, f"Dense_{fi}", "kernel"))
            self.map[f"{tname}.fc.{ti}.bias"] = (
                "params", self._path(fpath, f"Dense_{fi}", "bias"))


def upstream_flax_map(nstack: int = 4, depth: int = 4) -> UpstreamMap:
    """Every upstream ``PoseNet`` tensor name (skip convs included) → its
    Flax collection and path, in the JAX tool's walk order."""
    m = _Walk()
    nscale = depth + 1
    # backbone (layers_transposed.py:158-194): conv1+bn1, res1, res2,
    # the dilated convs
    m.conv("pre.conv1", "Backbone_0/ConvBlock_0/Conv_0")
    m.bn("pre.bn1", "Backbone_0/ConvBlock_0/BatchNorm_0")
    m.residual("pre.res1", "Backbone_0/Residual_0")
    m.residual("pre.res2", "Backbone_0/Residual_1")
    for k in range(6):
        m.conv_block(f"pre.dilation.{k}", f"Backbone_0/ConvBlock_{k + 1}")
    # hourglasses: the down path (skip, down) per depth, the innermost,
    # then the up path (low3 residual + refine conv) deepest first
    for i in range(nstack):
        f, t = f"Hourglass_{i}", f"hourglass.{i}.hg"
        for d in range(depth):
            m.residual(f"{t}.{d}.0", f"{f}/Residual_{2 * d}")
            m.residual(f"{t}.{d}.1", f"{f}/Residual_{2 * d + 1}")
        m.residual(f"{t}.{depth - 1}.4", f"{f}/Residual_{2 * depth}")
        for up, d in enumerate(reversed(range(depth))):
            m.residual(f"{t}.{d}.2", f"{f}/Residual_{2 * depth + 1 + up}")
            m.conv_block(f"{t}.{d}.3", f"{f}/ConvBlock_{up}")
    # feature heads: per scale two conv blocks and an SE gate
    for i in range(nstack):
        for j in range(nscale):
            t = f"features.{i}.before_regress.{j}"
            m.conv_block(f"{t}.0", f"Features_{i}/ConvBlock_{2 * j}")
            m.conv_block(f"{t}.1", f"Features_{i}/ConvBlock_{2 * j + 1}")
            m.se(f"{t}.2", f"Features_{i}/SELayer_{j}")
    # outs and merges, interleaved per stack and scale
    n = 0
    for i in range(nstack):
        for j in range(nscale):
            m.conv(f"outs.{i}.{j}.conv", f"ConvBlock_{n}/Conv_0", bias=True)
            n += 1
            if i != nstack - 1:
                m.conv_block(f"merge_preds.{i}.{j}.conv", f"ConvBlock_{n}")
                n += 1
                m.conv_block(f"merge_features.{i}.{j}.conv",
                             f"ConvBlock_{n}")
                n += 1
    return m.map


def upstream_key_map(model, nstack: int, depth: int) -> Dict[str, str]:
    """Upstream tensor name → ``model``'s state_dict key, for every tensor
    of ``model`` (an ``imhn`` / ``imhn_independent`` ``PoseNet``) bar BN's
    ``num_batches_tracked``.  Raises ``ValueError`` naming any model
    tensor that upstream's layout does not reach."""
    from ..models.convert import flax_leaf_map

    by_path = {(coll, path): key
               for key, (coll, path, _) in flax_leaf_map(model).items()}
    out = {}
    for ukey, where in upstream_flax_map(nstack, depth).items():
        key = by_path.pop(where, None)
        if key is not None:
            out[ukey] = key
    if by_path:
        raise ValueError("model tensors outside upstream's layout: "
                         + ", ".join(sorted(by_path.values())[:8]))
    return out


def strip_prefixes(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``sd`` with DDP's ``module.`` and upstream's ``posenet.`` wrapper
    prefixes removed (as the JAX tool removes them)."""
    out = {}
    for k, v in sd.items():
        for p in PREFIXES:
            k = k.replace(p, "")
        out[k] = v
    return out


def convert_upstream_state_dict(sd: Mapping[str, torch.Tensor], model,
                                nstack: int, depth: int
                                ) -> Dict[str, torch.Tensor]:
    """Upstream ``PoseNet`` state_dict (prefixes stripped) → ``model``'s
    state_dict, tensors as they are (float32, contiguous).  Raises
    ``ValueError`` naming every unmapped upstream key, unfilled model
    tensor and shape mismatch."""
    keys = upstream_key_map(model, nstack, depth)
    ref = model.state_dict()
    problems, out = [], {}
    for ukey, t in sd.items():
        if ukey.endswith("num_batches_tracked"):
            continue
        key = keys.get(ukey)
        if key is None:
            problems.append(f"unmapped upstream key {ukey}")
            continue
        t = torch.as_tensor(t)
        if tuple(t.shape) != tuple(ref[key].shape):
            problems.append(f"{ukey}: shape {tuple(t.shape)} != {key} "
                            f"{tuple(ref[key].shape)}")
            continue
        out[key] = t.detach().to("cpu", torch.float32).contiguous()
    for key, t in ref.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros_like(t, device="cpu")
        elif key not in out:
            problems.append(f"model tensor {key} left unfilled")
    if problems:
        raise ValueError("upstream import failed:\n  "
                         + "\n  ".join(problems))
    return out


def export_upstream_state_dict(model, nstack: int, depth: int,
                               prefix: str = "") -> Dict[str, torch.Tensor]:
    """The inverse: ``model``'s tensors under upstream's names (each BN
    with a zero ``num_batches_tracked``, as upstream saves it), every key
    prefixed with ``prefix`` (``"module."`` as DDP saves)."""
    sd = model.state_dict()
    out = {}
    for ukey, key in upstream_key_map(model, nstack, depth).items():
        out[prefix + ukey] = sd[key].detach().cpu().clone()
        if ukey.endswith(".running_var"):
            base = ukey[:-len("running_var")]
            out[prefix + base + "num_batches_tracked"] = torch.tensor(0)
    return out


def main(argv=None) -> str:
    """Import ``--pth`` into ``<--out>/epoch_<epoch>``; returns that
    path."""
    ap = argparse.ArgumentParser(
        description="import an upstream .pth checkpoint")
    ap.add_argument("--pth", required=True)
    ap.add_argument("--out", required=True,
                    help="checkpoint directory (the import is its "
                         "epoch_<N> entry)")
    ap.add_argument("--config", default="canonical")
    ap.add_argument("--unsafe-load", action="store_true",
                    help="allow full pickle deserialization for legacy "
                         "checkpoints that are not plain state dicts "
                         "(runs arbitrary code from the file; only for "
                         "trusted checkpoints)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..config import get_config
    from ..models import build_model
    from ..train import TrainState, save_checkpoint

    cfg = get_config(args.config)
    if cfg.model.variant not in VARIANTS:
        raise SystemExit(
            f"config '{args.config}' selects variant '{cfg.model.variant}'; "
            "upstream's .pth layout is the canonical IMHN's only "
            "(variants imhn / imhn_independent)")
    device = resolve_device(args.device)
    payload = torch.load(args.pth, map_location="cpu",
                         weights_only=not args.unsafe_load)
    sd = strip_prefixes(payload.get("weights", payload))
    model = build_model(cfg, dtype=torch.float32, device=device)
    model.load_state_dict(convert_upstream_state_dict(
        sd, model, cfg.model.nstack, cfg.model.hourglass_depth),
        strict=True)
    loss = float(payload.get("train_loss", 0.0))
    path = save_checkpoint(args.out, TrainState(model=model, optimizer=None),
                           int(payload.get("epoch", 0)), loss, loss)
    print(f"imported {args.pth} -> {path}")
    return path


if __name__ == "__main__":
    main()
