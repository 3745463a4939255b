"""Process groups, the device mesh and the topology stamp (counterpart of
``improved_body_parts_tpu/parallel/mesh.py``; reference:
train_distributed.py:69-146, NCCL process groups + DDP).

The JAX package runs one SPMD program over every device.  The port runs
one process a card (a *rank*), joined by ``torch.distributed``: NCCL when
the ranks hold CUDA tensors, gloo on the CPU.  A mesh is a 2-D
``torch.distributed.device_mesh.DeviceMesh`` over the ranks with dims
``('data', 'model')``, rank ``r`` at coordinate ``(r // model, r %
model)``, as the JAX package lays its devices out row-major:

- ``data`` splits the global batch: rank ``(d, m)`` trains rows ``[d*B,
  (d+1)*B)`` of each global batch of ``data * B`` rows;
- ``model`` splits partitioned leaves (``parallel.partition``); the ranks
  of one ``data`` coordinate see the same rows.

A single process is a world of one: :func:`make_mesh` brings up a
one-rank group on a free localhost port when none is running, so a
partitioned run on one card takes the same path as a multi-process one.

:func:`mesh_topology` is the checkpoint's device-topology stamp, with the
JAX package's keys (``process_count``, ``device_count``, ``platform``,
``mesh_devices``, ``mesh_axes``, ``partition_rules``), so a stamp of
either package reads the same.  Checkpoints written by the port before
the stamp existed carry ``{"devices": 1, "processes": 1}`` or nothing;
both read as one process on one card.
"""
from __future__ import annotations

import datetime
import socket
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

MESH_AXES = ("data", "model")

#: the stamp the port's checkpoints carried before the topology stamp
LEGACY_STAMP = {"devices": 1, "processes": 1}

#: how long a collective (and the process group's start) waits for every
#: rank before it raises
GROUP_TIMEOUT = datetime.timedelta(seconds=600)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def process_count() -> int:
    """Ranks in the running process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device, rank: Optional[int] = None) -> torch.device:
    """The device rank ``rank`` (this process's by default) drives: card
    ``rank % device_count`` for CUDA, the CPU otherwise."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if device.index is not None:
        return device
    rank = process_index() if rank is None else rank
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device="cuda", backend: Optional[str] = None
                           ) -> bool:
    """Join ``num_processes`` ranks at ``coordinator_address``
    (``host:port`` or a ``tcp://`` URL; rank 0 listens there).  Replaces
    ``dist.init_process_group('nccl')`` (train_distributed.py:82).

    The backend follows ``device``: NCCL for CUDA, with this rank's card
    (``process_id % device_count``) made current and the communicator
    brought up here, so a failed init raises now; gloo for the CPU.
    ``backend`` overrides that choice (two ranks on one card need gloo:
    NCCL refuses two ranks on one device); nothing falls back by itself.

    A no-op, returning False, for a single process without a coordinator
    and when the running group already matches; True when this call
    started the group."""
    n = int(num_processes or 1)
    if n <= 1 and coordinator_address is None:
        return False
    pid = int(process_id or 0)
    if not 0 <= pid < n:
        raise ValueError(f"process id {pid} is out of range for {n} "
                         "processes")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (n, pid):
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks (this "
                f"rank {dist.get_rank()}) is already running; asked for "
                f"rank {pid} of {n}")
        return False
    if not coordinator_address:
        raise ValueError(f"{n} processes need a coordinator address "
                         "(host:port of rank 0)")
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {}
    if device.type == "cuda":
        dev = rank_device(device, pid)
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=url, world_size=n, rank=pid,
        timeout=GROUP_TIMEOUT, **kwargs)
    return True


def shutdown_distributed() -> None:
    """Leave the process group (every rank together, as ranks exit)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Align every rank here.  Per-rank work before the first collective
    (imports, corpus open, model build) can drift ranks apart; the
    process group's timeout (:data:`GROUP_TIMEOUT`) bounds the
    wait.  A no-op for one process."""
    if process_count() > 1:
        dist.barrier()


def make_mesh(data: Optional[int] = None, model: int = 1,
              device="cuda"):
    """The ``('data', 'model')`` mesh over every rank of the process
    group (a one-rank group on ``device`` is started when none runs).
    ``data=None`` takes every rank divided by ``model``; ``data * model``
    must equal the number of ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                               device=device)
    n = dist.get_world_size()
    if data is None:
        if n % model:
            raise ValueError(f"{n} ranks do not split into model axis "
                             f"{model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the process group has {n}")
    return init_device_mesh(torch.device(device).type, (data, model),
                            mesh_dim_names=MESH_AXES)


def is_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, DeviceMesh)


def check_mesh(mesh, where: str) -> None:
    """Raise ``TypeError`` unless ``mesh`` is a ``make_mesh`` mesh."""
    if not is_mesh(mesh) or tuple(mesh.mesh_dim_names or ()) != MESH_AXES:
        raise TypeError(f"{where}: mesh must be a ('data', 'model') "
                        "DeviceMesh from parallel.make_mesh, got "
                        f"{type(mesh).__name__}")


def axis_sizes(mesh) -> Dict[str, int]:
    """``{'data': D, 'model': M}`` of a mesh, or of a mapping of axis
    name to size (a layout computed for a mesh this process is not
    part of)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return {name: int(mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names)}


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))


def axes_group(mesh, axes: Tuple[str, ...]):
    """The process group of the ranks that differ only along ``axes``
    and this rank's index in it.  ``('data', 'model')`` is every rank, in
    rank order, which is that composite axis's order."""
    axes = tuple(axes)
    if axes == MESH_AXES:
        return dist.group.WORLD, dist.get_rank()
    if len(axes) == 1:
        return mesh.get_group(axes[0]), axis_index(mesh, axes[0])
    raise ValueError(f"mesh axes {axes}: shard over one axis or over "
                     f"{MESH_AXES} in that order")


def mesh_platform(mesh=None, device=None) -> str:
    """The JAX package's platform names: ``gpu`` for CUDA, else the
    device type."""
    if mesh is not None and not isinstance(mesh, Mapping):
        kind = mesh.device_type
    elif device is not None:
        kind = torch.device(device).type
    else:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    return "gpu" if kind == "cuda" else kind


def mesh_topology(mesh=None, partition_rules: Optional[str] = None,
                  device=None) -> Dict:
    """JSON-able description of the layout a run executes on, stamped
    into every checkpoint's ``COMMIT.json`` so a restart on another
    layout is detected at restore time (``train.supervisor``).  One card
    a rank, so ``device_count`` is the number of ranks.
    ``partition_rules`` is the 12-hex ruleset fingerprint of a
    partitioned run (``parallel.partition.rules_fingerprint``); absent
    for the replicated regime.  ``mesh`` may be a mapping of axis name
    to size (a layout described without joining it)."""
    n = process_count()
    topo = {"process_count": n, "device_count": n,
            "platform": mesh_platform(mesh, device)}
    if mesh is not None:
        sizes = axis_sizes(mesh)
        topo["mesh_devices"] = int(np.prod(list(sizes.values())))
        topo["mesh_axes"] = sizes
    if partition_rules is not None:
        topo["partition_rules"] = str(partition_rules)
    return topo


def _read_stamp(stamped: Dict) -> Dict:
    """The port's stamp before this one, ``{"devices": d, "processes":
    p}``, in the JAX package's keys."""
    if "devices" in stamped and "process_count" not in stamped:
        return {"process_count": int(stamped.get("processes", 1)),
                "device_count": int(stamped["devices"])}
    return stamped


def topology_mismatch(stamped: Optional[Dict], mesh=None,
                      process_count: Optional[int] = None,
                      partition_rules: Optional[str] = None,
                      device=None) -> Optional[Dict[str, Tuple]]:
    """``{field: (stamped, current)}`` for every field where a
    checkpoint's stamp differs from the current layout, or None when
    they match or the checkpoint carries no stamp.  A stamped ruleset
    fingerprint diffs against ``partition_rules`` (None = replicated);
    a stamp without one checks nothing there, so a replicated run can
    adopt partitioning."""
    if not stamped:
        return None
    stamped = _read_stamp(stamped)
    current = mesh_topology(mesh, partition_rules=partition_rules,
                            device=device)
    if process_count is not None:
        current["process_count"] = int(process_count)
    diff = {}
    for key in ("process_count", "device_count", "platform",
                "mesh_devices", "mesh_axes"):
        if key in stamped and key in current \
                and stamped[key] != current[key]:
            diff[key] = (stamped[key], current[key])
    if "partition_rules" in stamped \
            and stamped["partition_rules"] != current.get("partition_rules"):
        diff["partition_rules"] = (stamped["partition_rules"],
                                   current.get("partition_rules"))
    return diff or None


def state_tensors(state) -> Sequence[torch.Tensor]:
    """Every tensor of a full (unsharded) train state, in a fixed order:
    the model's parameters and buffers, the momentum, the update count
    and the SWA average."""
    out = list(state.model.state_dict().values())
    opt = state.optimizer
    if opt is not None:
        out += list(opt.momentum) + [opt.count]
    out += [state.swa_params[k] for k in sorted(state.swa_params or {})]
    return out


def reshard_replicated(state):
    """Re-place a restored state onto the mesh replicated: rank 0's
    values are broadcast to every rank, so the ranks start the next step
    from one state (reshard-on-restore for the replicated regime).  The
    state must be full (``state.sharding`` None)."""
    if getattr(state, "sharding", None) is not None:
        raise ValueError("reshard_replicated: the state is sharded; use "
                         "parallel.partition.reshard_tree")
    if process_count() > 1:
        with torch.no_grad():
            for t in state_tensors(state):
                dist.broadcast(t, 0)
    return state


def shard_batch(batch, mesh, spatial_shard: bool = False,
                stride: Optional[int] = None):
    """This rank's rows of a global batch (a tuple of arrays or tensors
    with the batch first): the ``data`` coordinate's contiguous slab, so
    the slabs of the ranks in rank order reassemble the global batch.

    ``spatial_shard=True`` also cuts the height (axis 1) over
    ``'model'``, as the JAX package's ``P('data', 'model', None, None)``:
    this rank's rows of the row split at the network's total ``stride``
    (``parallel.spatial.split_units``; required then), every array cut at
    the same bottom rows."""
    sizes = axis_sizes(mesh)
    d, D = axis_index(mesh, "data"), sizes["data"]
    if spatial_shard and stride is None:
        raise ValueError("shard_batch(spatial_shard=True) needs the "
                         "network's total stride (the row split's unit)")
    out = []
    for x in batch:
        n = x.shape[0]
        if n % D:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{D} data ranks")
        out.append(x[d * n // D:(d + 1) * n // D])
    if spatial_shard:
        from .spatial import spatial_rows

        return spatial_rows(out, mesh, stride)
    return tuple(out)
