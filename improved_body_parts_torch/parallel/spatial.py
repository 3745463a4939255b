"""Height-sharded inference: the exchanges GSPMD inserts under
``P('data', 'model', None, None)`` in the JAX package
(``Predictor(mesh=)``, ``parallel/mesh.py batch_sharding(spatial_shard=
True)``), written out over ``torch.distributed``.

The ``'model'`` ranks of a mesh split an image's height:

- **the row split** (:func:`split_units`): the padded height H is H / S
  bottom rows of the network's total stride S (4 x 2^hourglass_depth: 64
  for the published configs, 16 for ``tiny``), dealt out as evenly as
  possible in rank order (the 640-row bucket over 4 ranks: 3 / 3 / 2 / 2
  bottom rows) and scaled back up by S.  Every shard starts on a
  multiple of S, so every 2x2 max pool and nearest 2x upsample at every
  level stays on its rank.  Fewer bottom rows than ranks is refused;
  nothing is padded further (that would move the SE means, and so the
  maps);
- **the halo exchange** (:meth:`HeightShard.halo`): a convolution's
  ``lo`` rows above and ``hi`` rows below come from the neighbouring
  ranks (from further ones where a neighbour holds fewer rows), zeros
  past the image's top and bottom, which is what ``SAME`` padding gives
  there.  Built on one ``all_gather`` of every rank's edge rows, which
  runs under gloo (the CPU, and CUDA tensors) and NCCL alike;
- **the sharded mean** (:meth:`HeightShard.mean_hw`): the SE layers'
  global average pool, each rank's row sums ``all_reduce``d and divided
  by the global H x W;
- **the gather** (:meth:`HeightShard.gather`): the shards of a result
  (uneven heights) concatenated in rank order on every rank.

The layers (``models.layers``) run a shard inside
:func:`models.layers.height_sharded`; without it they run the plain
forward, unchanged.  :data:`COLLECTIVES` counts the collectives a
sharded forward issues, by kind.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

#: collectives issued by height shards since the last reset, by kind
COLLECTIVES = {"halo": 0, "mean": 0, "gather": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def network_stride(model) -> int:
    """The total stride S of a model from ``models.build_model`` (its
    ``total_stride``): the unit of the row split."""
    stride = getattr(model, "total_stride", None)
    if stride is None:
        raise TypeError(f"{type(model).__name__} has no total_stride: a "
                        "height-sharded forward needs a model of "
                        "models.build_model")
    return int(stride)


def split_units(height: int, stride: int, parts: int) -> List[int]:
    """Bottom rows (of ``stride`` input rows each) of each of ``parts``
    ranks, in rank order: as even as possible, the first ranks taking
    one more."""
    if height % stride:
        raise ValueError(f"a height of {height} rows is no multiple of the "
                         f"network's total stride {stride}")
    units = height // stride
    if units < parts:
        raise ValueError(
            f"a height of {height} rows (H/S = {units} bottom rows at the "
            f"network's total stride S = {stride}) does not split over M = "
            f"{parts} 'model' ranks: H/S < M")
    base, extra = divmod(units, parts)
    return [base + (r < extra) for r in range(parts)]


class HeightShard:
    """This rank's share of a forward whose height is split over the
    ranks of ``group``: ``units[r]`` bottom rows on rank ``r``, this
    rank ``rank``, input rows ``rows``.

    A layer's local height ``h`` is ``units[rank]`` times its level's
    rows a unit, so every rank's height at that level, and the global
    one, follow from ``h`` alone."""

    def __init__(self, units: Sequence[int], rank: int, group,
                 stride: int):
        self.units = tuple(int(u) for u in units)
        self.rank = int(rank)
        self.group = group
        start = sum(self.units[:rank]) * stride
        self.rows = (start, start + self.units[rank] * stride)

    @classmethod
    def over(cls, mesh, height: int, stride: int) -> "HeightShard":
        """This rank's shard of a ``height``-row input over ``mesh``'s
        ``'model'`` axis."""
        from .mesh import axis_index, axis_sizes

        units = split_units(height, stride, axis_sizes(mesh)["model"])
        return cls(units, axis_index(mesh, "model"), mesh.get_group("model"),
                   stride)

    def heights(self, local: int) -> List[int]:
        """Every rank's height at the level where this rank holds
        ``local`` rows."""
        per, rest = divmod(local, self.units[self.rank])
        if rest:
            raise ValueError(f"{local} rows are no whole number of this "
                             f"rank's {self.units[self.rank]} bottom rows")
        return [u * per for u in self.units]

    def global_height(self, local: int) -> int:
        return sum(self.heights(local))

    def halo(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """NCHW ``x`` with ``lo`` rows of the ranks above and ``hi`` rows
        of the ranks below around it (zeros past the global top and
        bottom).  Every rank sends its first ``hi`` and last ``lo`` rows
        (fewer where it holds fewer) in one ``all_gather``."""
        if lo == 0 and hi == 0:
            return x
        heights = self.heights(x.shape[2])
        h = x.shape[2]
        head = x[:, :, :min(hi, h)]
        tail = x[:, :, h - min(lo, h):]
        send = torch.cat([F.pad(head, (0, 0, 0, hi - head.shape[2])),
                          F.pad(tail, (0, 0, 0, lo - tail.shape[2]))],
                         dim=2).contiguous()
        recv = [torch.empty_like(send) for _ in heights]
        dist.all_gather(recv, send, group=self.group)
        COLLECTIVES["halo"] += 1
        above, need, q = [], lo, self.rank - 1
        while need and q >= 0:
            kept = min(lo, heights[q])
            take = min(need, kept)
            above.insert(0, recv[q][:, :, hi + kept - take:hi + kept])
            need -= take
            q -= 1
        if need:
            above.insert(0, x.new_zeros(x.shape[0], x.shape[1], need,
                                        x.shape[3]))
        below, need, q = [], hi, self.rank + 1
        while need and q < len(heights):
            take = min(need, heights[q], hi)
            below.append(recv[q][:, :, :take])
            need -= take
            q += 1
        if need:
            below.append(x.new_zeros(x.shape[0], x.shape[1], need,
                                     x.shape[3]))
        return torch.cat(above + [x] + below, dim=2)

    def mean_hw(self, x: torch.Tensor) -> torch.Tensor:
        """``x.mean(dim=(2, 3))`` over the global height: this rank's
        sums (in float32 at least) summed over the ranks, divided by
        H x W."""
        dt = torch.promote_types(x.dtype, torch.float32)
        s = x.sum(dim=(2, 3), dtype=dt)
        dist.all_reduce(s, group=self.group)
        COLLECTIVES["mean"] += 1
        return (s / (self.global_height(x.shape[2]) * x.shape[3])).to(
            x.dtype)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along its height ``dim`` in
        rank order (the ranks' heights may differ)."""
        heights = self.heights(x.shape[dim])
        top = max(heights)
        pad = list(x.shape)
        pad[dim] = top - x.shape[dim]
        send = torch.cat([x, x.new_zeros(pad)], dim=dim).contiguous()
        recv = [torch.empty_like(send) for _ in heights]
        dist.all_gather(recv, send, group=self.group)
        COLLECTIVES["gather"] += 1
        return torch.cat([r.narrow(dim, 0, n)
                          for r, n in zip(recv, heights)], dim=dim)


def gather_lanes(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every rank of ``group``'s ``x`` (equal shapes) concatenated along
    the batch, in rank order; ``x`` itself for one rank."""
    if size <= 1:
        return x
    recv = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(recv, x.contiguous(), group=group)
    COLLECTIVES["gather"] += 1
    return torch.cat(recv, dim=0)


def spatial_rows(batch, mesh, stride: int):
    """This rank's ``'model'`` rows of every array of ``batch`` (the
    batch first, the height second): the row split of the first
    array's height at ``stride``, each array cut at the same bottom
    rows (its height must be a whole number of them)."""
    from .mesh import axis_index, axis_sizes

    batch = tuple(batch)
    units = split_units(int(batch[0].shape[1]), stride,
                        axis_sizes(mesh)["model"])
    m = axis_index(mesh, "model")
    total, first = sum(units), sum(units[:m])
    out = []
    for x in batch:
        h = int(x.shape[1])
        if h % total:
            raise ValueError(f"an array of height {h} does not split into "
                             f"the batch's {total} bottom rows")
        per = h // total
        out.append(x[:, first * per:(first + units[m]) * per])
    return tuple(out)
