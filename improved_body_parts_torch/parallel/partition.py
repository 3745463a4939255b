"""Partition rules: which leaves of the train state are held sharded, and
along which axis (counterpart of
``improved_body_parts_tpu/parallel/partition.py``).

A rule is ``(regex, spec)``.  The regex is searched in the leaf's path and
the first rule that matches wins; the spec is a plain tuple with one
entry per axis, each None (not split) or mesh axis names.  The rules and
leaf paths are the JAX package's own, so one ruleset text gives one
layout in both packages and :func:`rules_fingerprint` hashes the same
bytes there and here (``repr(tuple(spec))``): stamps stay comparable.

- A leaf's path is its Flax path (``params/Backbone_0/ConvBlock_0/
  Conv_0/kernel``, ``batch_stats/...``, ``opt_state/1/0/trace/...``,
  ``opt_state/1/1/count``, ``step``), which ``models.convert``'s leaf
  map gives for each ``state_dict`` key; the SGD momentum of a parameter
  takes the path of its optax trace.
- A spec names axes in the JAX package's layout.  Flax kernels are HWIO,
  so a conv's out-channel axis is the last; a torch ``Conv2d.weight`` is
  OIHW, so the same axis is dim 0 here (a ``ConvTranspose2d.weight``,
  (in, out, kH, kW), would hold it in dim 1).  :func:`train_state_
  shardings` maps each spec through the converter's transpose, and
  :func:`refine_spec` decides on the Flax shape, so divisibility and the
  ``min_shard_dim`` floor see the out-channel extent either way.
- :func:`refine_spec` drops an axis the mesh cannot split evenly, or one
  that would leave fewer than ``min_shard_dim`` elements a rank: the leaf
  is then replicated, as in the JAX package.

``parallel.sharded.ShardedState`` turns a layout into storage: each rank
holds its chunk of every sharded leaf and of its momentum.
"""
from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

#: a rule: (regex over the '/'-joined leaf path, spec).  First match wins.
PartitionRule = Tuple[str, Tuple]

#: leaves at/below this many elements are never sharded
_SCALAR_ELEMS = 1

#: default floor on the per-rank extent along a sharded axis
DEFAULT_MIN_SHARD_DIM = 8

#: torch dim i of a converted leaf holds Flax dim ``_PERMS[how][i]``
#: (``models.convert._TRANSFORMS``)
_PERMS = {"conv": (3, 2, 0, 1), "dense": (1, 0)}


class UnmatchedLeafError(ValueError):
    """Strict mode: at least one non-scalar leaf matched no rule."""


def refine_spec(spec: Tuple, shape: Sequence[int], mesh,
                min_shard_dim: int = DEFAULT_MIN_SHARD_DIM) -> Tuple:
    """``spec`` with every axis the leaf cannot support dropped: kept only
    when the mesh axes' size divides the dimension exactly and leaves at
    least ``min_shard_dim`` elements a rank.  ``mesh`` is a mesh or a
    mapping of axis name to size."""
    from .mesh import axis_sizes

    spec = tuple(spec)
    if not spec:
        return spec
    sizes = axis_sizes(mesh)
    out = []
    for dim, axes in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        if axes is None:
            out.append(None)
            continue
        names = axes if isinstance(axes, tuple) else (axes,)
        total = int(np.prod([sizes.get(a, 1) for a in names]))
        if total <= 1 or dim % total != 0 or dim // total < min_shard_dim:
            out.append(None)
        else:
            out.append(axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def match_partition_rules(rules: Sequence[PartitionRule],
                          shapes: Mapping[str, Sequence[int]], *,
                          strict: bool = False, mesh=None,
                          min_shard_dim: int = DEFAULT_MIN_SHARD_DIM
                          ) -> Dict[str, Tuple]:
    """``{path: spec}`` for ``shapes`` (path → shape in the JAX package's
    layout) from first-match-wins ``re.search`` rules.  Scalar leaves get
    ``()``.  ``strict=True`` raises :class:`UnmatchedLeafError` naming
    every unmatched non-scalar leaf (the default replicates them).  With
    ``mesh``, each matched spec is refined against the leaf's shape."""
    compiled = [(re.compile(pat), tuple(spec)) for pat, spec in rules]
    unmatched: List[str] = []
    specs: Dict[str, Tuple] = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        if int(np.prod(shape)) <= _SCALAR_ELEMS:
            specs[name] = ()
            continue
        for pat, spec in compiled:
            if pat.search(name):
                if mesh is not None:
                    spec = refine_spec(spec, shape, mesh,
                                       min_shard_dim=min_shard_dim)
                specs[name] = spec
                break
        else:
            unmatched.append(name)
            specs[name] = ()
    if strict and unmatched:
        shown = ", ".join(unmatched[:8])
        more = f" (+{len(unmatched) - 8} more)" if len(unmatched) > 8 else ""
        raise UnmatchedLeafError(
            f"{len(unmatched)} leaves matched no partition rule under "
            f"strict mode: {shown}{more}. Every leaf must be covered — "
            "add a rule (a trailing ('.*', ()) replicates the remainder "
            "explicitly).")
    return specs


def imhn_partition_rules() -> Tuple[PartitionRule, ...]:
    """The IMHN default: wide conv kernels shard their out-channel axis
    (Flax's last) over ``'model'``; everything else replicates."""
    return (
        (r"(Conv|ConvTranspose)_\d+/kernel$", (None, None, None, "model")),
        (r".*", ()),
    )


def imhn_fsdp_rules() -> Tuple[PartitionRule, ...]:
    """The FSDP/ZeRO-style variant: wide conv kernels shard over the
    whole mesh, ``('data', 'model')``, so a pure data-parallel mesh splits
    the state across its ranks too."""
    return (
        (r"(Conv|ConvTranspose)_\d+/kernel$",
         (None, None, None, ("data", "model"))),
        (r".*", ()),
    )


#: named rulesets (``cli.train --partition-rules``); ``replicated`` is
#: the explicit everything-replicated set
NAMED_RULESETS: Dict[str, Tuple[PartitionRule, ...]] = {
    "imhn": imhn_partition_rules(),
    "imhn_fsdp": imhn_fsdp_rules(),
    "replicated": ((r".*", ()),),
}


def get_ruleset(name: str) -> Tuple[PartitionRule, ...]:
    if name not in NAMED_RULESETS:
        raise KeyError(f"unknown partition ruleset {name!r}; "
                       f"available: {sorted(NAMED_RULESETS)}")
    return NAMED_RULESETS[name]


def rules_fingerprint(rules: Sequence[PartitionRule],
                      min_shard_dim: int = DEFAULT_MIN_SHARD_DIM) -> str:
    """12-hex identity of a layout, stamped into every checkpoint so a
    resume under other rules is refused: pattern order, spec content and
    the refinement floor, hashed as the JAX package hashes them."""
    h = hashlib.sha256()
    for pat, spec in rules:
        h.update(pat.encode())
        h.update(repr(tuple(spec)).encode())
        h.update(b"\0")
    h.update(f"min_shard_dim={int(min_shard_dim)}".encode())
    return h.hexdigest()[:12]


def shards_anything(rules: Sequence[PartitionRule]) -> bool:
    """True when some rule names a mesh axis (else the set replicates)."""
    return any(any(a is not None for a in spec) for _, spec in rules)


@dataclass(frozen=True)
class LeafLayout:
    """Where one leaf of the train state lives.  ``key`` names the tensor
    in the port (``state_dict`` key, ``momentum/<param>``,
    ``optimizer/count`` or ``step``); ``spec`` is the refined spec in the
    JAX package's layout; ``dim`` the torch dim it splits (None when
    replicated), over mesh ``axes`` into ``shards`` chunks."""
    key: str
    spec: Tuple
    dim: Optional[int] = None
    axes: Tuple[str, ...] = ()
    shards: int = 1


def state_leaf_paths(model, optimizer=None
                     ) -> Dict[str, Tuple[str, Tuple[int, ...], Tuple]]:
    """``{path: (key, perm, reference shape)}`` for every leaf of a port
    train state: parameters and BN running stats (by the converter's leaf
    map), the momentum, the update count and the step.  ``perm[i]`` is
    the reference dim that torch dim ``i`` holds."""
    from ..models.convert import flax_leaf_map

    leaf_map = flax_leaf_map(model)
    sd = model.state_dict()
    out = {}
    for key, t in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        coll, fpath, how = leaf_map[key]
        perm = _PERMS.get(how, tuple(range(t.dim())))
        ref = tuple(int(t.shape[perm.index(i)]) for i in range(t.dim()))
        out[f"{coll}/{'/'.join(fpath)}"] = (key, perm, ref)
    if optimizer is not None:
        k = 2 if optimizer.max_grad_norm > 0 else 1
        names = {p: n for n, p in model.named_parameters()}
        for p in optimizer.params:
            coll, fpath, how = leaf_map[names[p]]
            perm = _PERMS.get(how, tuple(range(p.dim())))
            ref = tuple(int(p.shape[perm.index(i)]) for i in range(p.dim()))
            out[f"opt_state/{k}/0/trace/{'/'.join(fpath)}"] = (
                f"momentum/{names[p]}", perm, ref)
        out[f"opt_state/{k}/1/count"] = ("optimizer/count", (), ())
    out["step"] = ("step", (), ())
    return out


def train_state_shardings(model, optimizer, mesh,
                          rules: Sequence[PartitionRule], *,
                          strict: bool = True,
                          min_shard_dim: int = DEFAULT_MIN_SHARD_DIM
                          ) -> Dict[str, LeafLayout]:
    """``{path: LeafLayout}`` for every leaf of the train state of
    ``model`` and ``optimizer`` on ``mesh`` (a mesh, or a mapping of axis
    name to size): the rules matched on the JAX package's paths and
    shapes, refined, and mapped to torch dims.  Strict by default: a new
    parameter the rules miss fails here, naming the leaf.  Momentum is
    laid out as its parameter."""
    leaves = state_leaf_paths(model, optimizer)
    specs = match_partition_rules(
        rules, {p: ref for p, (_, _, ref) in leaves.items()},
        strict=strict, mesh=mesh, min_shard_dim=min_shard_dim)
    from .mesh import axis_sizes

    sizes = axis_sizes(mesh)
    out = {}
    for path, (key, perm, _) in leaves.items():
        spec = specs[path]
        split = [(i, a) for i, a in enumerate(spec) if a is not None]
        if not split:
            out[path] = LeafLayout(key, spec)
            continue
        if len(split) > 1:
            raise ValueError(f"{path}: spec {spec} splits {len(split)} "
                             "axes; the port holds a leaf split along one")
        ref_axis, axes = split[0]
        axes = axes if isinstance(axes, tuple) else (axes,)
        out[path] = LeafLayout(key, spec, dim=perm.index(ref_axis),
                               axes=tuple(axes),
                               shards=int(np.prod([sizes[a] for a in axes])))
    return out


def sharding_summary(layout: Mapping[str, LeafLayout]) -> Dict[str, int]:
    """``{sharded, replicated}`` leaf counts of a layout, as the JAX
    package counts them over its state's leaves."""
    sharded = sum(1 for lay in layout.values() if lay.dim is not None)
    return {"sharded": sharded, "replicated": len(layout) - sharded}


def reshard_tree(state, mesh, rules: Sequence[PartitionRule], *,
                 min_shard_dim: int = DEFAULT_MIN_SHARD_DIM):
    """Re-place a restored, full state onto ``mesh`` under ``rules``:
    rank 0's values go to every rank and each rank keeps its chunk of
    every sharded leaf (``parallel.sharded.ShardedState``).  The sharded
    twin of ``mesh.reshard_replicated``."""
    from .sharded import ShardedState

    layout = train_state_shardings(state.model, state.optimizer, mesh,
                                   rules, min_shard_dim=min_shard_dim)
    ShardedState(state.model, state.optimizer, mesh, layout).place(state)
    return state
