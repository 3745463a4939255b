"""The storage of a partitioned train state: gather at use, reduce and
scatter after.

A layout (``parallel.partition.train_state_shardings``) says, leaf by
leaf, which tensors are split and along which torch dim.  Between steps
each rank holds only its chunk of a split parameter and of its SGD
momentum (the chunk at its index along the leaf's mesh axes); every other
leaf is replicated.  A train step then:

1. :meth:`ShardedState.gather`: all-gathers each split parameter into its
   full tensor for the forward and backward;
2. runs forward and backward on the rank's rows;
3. :meth:`ShardedState.reduce_grads`: sums every gradient over the
   ``'data'`` ranks (the global-batch gradient), scaled as the step asks,
   keeps this rank's chunk of each split one and puts the chunks back as
   the parameters, so the fused SGD update runs on chunks.

Leaves the refinement left whole are replicated and reduced like DDP's.
FSDP2 (``torch.distributed.fsdp.fully_shard``) is not used: it pads
uneven chunks and splits every parameter of a unit, where the JAX
package replicates each leaf its rules or the refinement leave whole.
The full parameters live for one forward and backward; the memory this
saves is the momentum's and the parameters' between steps.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

from .mesh import axes_group, axis_sizes
from .partition import LeafLayout

#: elements a flat all-reduce bucket holds (64 MiB of float32)
BUCKET_ELEMS = 16 << 20


class _Split:
    """One split parameter: its chunk, whether the parameter holds the
    full tensor right now, and where the chunk sits (dim, group, index
    in the group, chunk count)."""

    def __init__(self, param, dim: int, group, index: int, shards: int):
        self.param, self.dim = param, dim
        self.group, self.index, self.shards = group, index, shards
        self.chunk: Optional[torch.Tensor] = None
        self.gathered = False


class ShardedState:
    """Holds the split leaves of ``model`` and ``optimizer`` as chunks on
    ``mesh`` per ``layout`` (``{path: LeafLayout}``)."""

    def __init__(self, model, optimizer, mesh,
                 layout: Mapping[str, LeafLayout]):
        self.model, self.optimizer = model, optimizer
        params = dict(model.named_parameters())
        self.data_group = mesh.get_group("data")
        self.data_size = axis_sizes(mesh)["data"]
        self.splits: List[_Split] = []
        for lay in layout.values():
            if lay.dim is None or lay.key not in params:
                continue
            group, index = axes_group(mesh, lay.axes)
            self.splits.append(_Split(params[lay.key], lay.dim, group,
                                      index, lay.shards))
        self._by_param = {id(s.param): s for s in self.splits}

    # ---------------------------------------------------------- placement
    def place(self, state) -> None:
        """Lay a full state out: rank 0's values to every rank, then each
        rank keeps its chunk of every split parameter and momentum."""
        from .mesh import state_tensors

        if getattr(state, "sharding", None) is not None:
            state.sharding.unshard(state)
        with torch.no_grad():
            if dist.get_world_size() > 1:
                for t in state_tensors(state):
                    dist.broadcast(t, 0)
            opt_state = self.optimizer.sgd.state
            for s in self.splits:
                s.chunk = self._chunk(s, s.param.data)
                s.param.data = s.chunk
                buf = opt_state[s.param]["momentum_buffer"]
                opt_state[s.param]["momentum_buffer"] = self._chunk(s, buf)
                s.gathered = False
        state.sharding = self

    @staticmethod
    def _chunk(s: _Split, full: torch.Tensor) -> torch.Tensor:
        return full.chunk(s.shards, s.dim)[s.index].contiguous()

    def _all_gather(self, s: _Split, chunk: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(chunk) for _ in range(s.shards)]
        dist.all_gather(parts, chunk.contiguous(), group=s.group)
        return torch.cat(parts, dim=s.dim)

    def unshard(self, state) -> None:
        """Back to full tensors on every rank (parameters and momentum):
        before a restore into the state, or to hand the model to code
        that wants it whole."""
        with torch.no_grad():
            self.release()
            opt_state = self.optimizer.sgd.state
            for s in self.splits:
                s.param.data = self._all_gather(s, s.chunk)
                buf = opt_state[s.param]["momentum_buffer"]
                opt_state[s.param]["momentum_buffer"] = self._all_gather(
                    s, buf)
                s.chunk = None
        state.sharding = None

    # ---------------------------------------------------------- the step
    def gather(self) -> None:
        """Full parameters for a forward (and backward)."""
        with torch.no_grad():
            for s in self.splits:
                if not s.gathered:
                    s.param.data = self._all_gather(s, s.chunk)
                    s.gathered = True

    def release(self) -> None:
        """The chunks back as the parameters (after an eval forward)."""
        for s in self.splits:
            if s.gathered:
                s.param.data = s.chunk
                s.gathered = False

    def reduce_grads(self, params, scale: float = 1.0) -> None:
        """Sum ``p.grad`` of every parameter over the ``'data'`` ranks,
        times ``scale``; each split parameter then takes back its chunk
        and its gradient's chunk."""
        grads = [p.grad for p in params if p.grad is not None]
        all_reduce_flat(grads, self.data_group, self.data_size, scale)
        for s in self.splits:
            g = s.param.grad
            s.param.grad = None
            s.param.data = s.chunk
            s.gathered = False
            if g is not None:
                s.param.grad = self._chunk(s, g)

    def grad_norm(self, params) -> torch.Tensor:
        """The global norm of the gradients in ``p.grad``: the squares of
        each split gradient's chunks summed over its group."""
        split = {id(s.param) for s in self.splits}
        dt = torch.promote_types(params[0].dtype, torch.float32)
        total = torch.zeros((), dtype=dt, device=params[0].device)
        by_group: Dict[int, list] = {}
        for p in params:
            sq = torch.linalg.vector_norm(p.grad, dtype=dt) ** 2
            if id(p) in split:
                s = self._by_param[id(p)]
                by_group.setdefault(id(s.group), [s.group, []])[1].append(sq)
            else:
                total = total + sq
        for group, parts in by_group.values():
            part = torch.stack(parts).sum()
            dist.all_reduce(part, group=group)
            total = total + part
        return torch.sqrt(total)

    # -------------------------------------------------------- checkpoint
    def full_named(self, named: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """``named`` (the checkpoint's ``model/<key>`` and
        ``momentum/<param>`` names, as ``train.checkpoint`` flattens a
        state) with every split leaf all-gathered to its full tensor.  A
        collective: every rank calls it."""
        self.release()
        names = {id(p): n for n, p in self.model.named_parameters()}
        split = {names[id(s.param)]: s for s in self.splits}
        out = {}
        for key, t in named.items():
            kind, _, name = key.partition("/")
            s = split.get(name) if kind in ("model", "momentum") else None
            out[key] = t if s is None else self._all_gather(s, t)
        return out


def all_reduce_flat(tensors, group, size: int, scale: float = 1.0) -> None:
    """Sum ``tensors`` in place over ``group`` (``size`` ranks), times
    ``scale``, through flat buckets of at most :data:`BUCKET_ELEMS`
    elements (one collective a bucket).  With one rank only the scale is
    applied."""
    if size <= 1:
        if scale != 1.0:
            for t in tensors:
                t.mul_(scale)
        return
    bucket: List[torch.Tensor] = []
    n = 0
    for t in list(tensors) + [None]:
        if t is not None and (not bucket or (
                n + t.numel() <= BUCKET_ELEMS
                and t.dtype == bucket[0].dtype)):
            bucket.append(t)
            n += t.numel()
            continue
        if bucket:
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, group=group)
            if scale != 1.0:
                flat.mul_(scale)
            off = 0
            for b in bucket:
                b.copy_(flat[off:off + b.numel()].view_as(b))
                off += b.numel()
        bucket, n = ([t], t.numel()) if t is not None else ([], 0)
