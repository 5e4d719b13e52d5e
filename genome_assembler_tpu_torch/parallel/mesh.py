"""A mesh of D shards, in one process or one rank a process, and its
collectives.

Counterpart of ``genome_assembler_tpu/parallel/mesh.py``. The reference
rides ``jax.sharding.Mesh`` + ``shard_map`` with XLA collectives over a
1-level mesh or a 2-level ``('host', 'chip')`` one whose rows are
processes. Here a mesh is D shards, each a ``torch.device``, and a
process drives the shards it owns:

  * **one process** (no process group): it owns all D shards, placed
    round-robin over an explicit device list, so one H100 can hold four
    shards (``build_mesh(4)``) and a four-GPU host one shard a card with
    the same call. ``hosts=h`` is then only a factorisation of D, as on
    the reference's forced CPU platform: ``num_hosts`` returns ``h`` and
    everything else is the flat mesh;
  * **several processes** (``init_distributed`` made a ``torch.distributed``
    process group before ``build_mesh``): ``hosts`` is the world size and
    rank r owns the ``D / hosts`` consecutive global shards from
    ``first_shard = r * D / hosts``. ``devices`` holds the devices of
    these local shards only.

The collectives are plain functions over lists of the **local** shards'
tensors (one entry a local shard, each on its shard's device) and give
each rank the local part of what the single-process mesh gives. Without
a process group they move tensors between the shards' devices; with one
they are one ``torch.distributed`` call each (NCCL on cards, gloo on the
CPU), also when the group has a single rank.

A multi-process run is launched with torch's own variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), as
``torchrun`` or ``parallel/launch.py::spawn`` set them: the identical
command on every rank, with the same reads file.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device


class Mesh(NamedTuple):
    """D shards; ``devices[i]`` is the device of LOCAL shard i, which is
    global shard ``first_shard + i``. ``hosts`` is the number of process
    rows; ``distributed`` says that the collectives go through the process
    group (else this process owns every shard)."""

    devices: tuple[torch.device, ...]
    hosts: int = 1
    first_shard: int = 0
    global_size: int | None = None
    distributed: bool = False

    @property
    def size(self) -> int:
        """The global shard count D."""
        return len(self.devices) if self.global_size is None else self.global_size

    @property
    def local_size(self) -> int:
        """Shards this process owns."""
        return len(self.devices)

    @property
    def local_shards(self) -> range:
        """Global ids of the shards this process owns."""
        return range(self.first_shard, self.first_shard + len(self.devices))

    @property
    def single_device(self) -> bool:
        """True when every local shard sits on one device."""
        return len(set(self.devices)) == 1

    @property
    def rank(self) -> int:
        return dist.get_rank() if self.distributed else 0

    def __str__(self) -> str:
        distinct = list(dict.fromkeys(str(d) for d in self.devices))
        text = f"{self.size} shard(s) on {', '.join(distinct)}"
        if self.distributed:
            text = (f"{self.size} shard(s) over {self.hosts} process(es), "
                    f"{self.local_size} here on {', '.join(distinct)}")
        return text


def process_group_live() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(
    backend: str | None = None,
    *,
    rank: int | None = None,
    world_size: int | None = None,
    init_method: str | None = None,
    timeout_s: float = 600.0,
) -> bool:
    """Make the ``torch.distributed`` process group of a multi-process run.

    The launch is read from torch's own variables (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as
    ``torchrun`` sets them) or from the keyword arguments (``init_method``
    such as ``tcp://localhost:29500`` with ``rank`` and ``world_size``).
    With neither there is no group and the run is a single process.
    backend: ``"nccl"`` (the default: ranks on cards) or ``"gloo"`` (the
    caller named the CPU); one is never taken in the other's place. Under
    NCCL the rank binds its card, ``cuda:LOCAL_RANK``, before the group is
    made. Every collective that a rank never enters fails the others
    after ``timeout_s``. Idempotent; returns True when more than one
    process runs.
    """
    if process_group_live():
        return dist.get_world_size() > 1
    env = os.environ
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and world_size is None and init_method is None:
        return False
    if rank is None or world_size is None:
        raise ValueError(
            "init_distributed: a multi-process launch needs both the rank "
            "and the world size (RANK and WORLD_SIZE, or the keywords)"
        )
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"init_distributed: unknown backend {backend!r}")
    if backend == "nccl":
        local_rank = int(env.get("LOCAL_RANK", rank))
        # raises without a card of that index: no fallback to gloo
        torch.cuda.set_device(resolve_device(f"cuda:{local_rank}"))
    if init_method is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError(
                "init_distributed: MASTER_ADDR and MASTER_PORT are not set "
                "and no init_method was given"
            )
        init_method = "env://"
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return world_size > 1


def shutdown_distributed() -> None:
    """Leave the process group, if one was made."""
    if process_group_live():
        dist.destroy_process_group()


def build_mesh(
    num_shards: int | None = None,
    devices: list[str | torch.device] | None = None,
    hosts: int | None = None,
) -> Mesh:
    """D = ``num_shards`` global shards; the local ones round-robin over
    ``devices``.

    devices defaults to every visible CUDA device (under a process group:
    the rank's bound card); without one this raises (the mesh never
    carries on on the CPU unless the caller names it, e.g.
    ``devices=["cpu"]``). num_shards defaults to the number of devices
    (times the number of processes) and the local shard count must be a
    multiple of the device count.

    hosts: the process rows of the reference's 2-level mesh. Under a live
    process group it defaults to, and must be, the world size, and this
    rank owns ``num_shards / hosts`` consecutive shards. In one process it
    is only a factorisation (``num_hosts`` returns it). A shard count
    that does not split evenly over the hosts raises ValueError.
    """
    live = process_group_live()
    world = dist.get_world_size() if live else 1
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_mesh: CUDA is not available on this machine and no "
                "device list was given (no fallback to the CPU)"
            )
        if live:
            devs = [torch.device("cuda", torch.cuda.current_device())]
        else:
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("build_mesh: empty device list")
    if live:
        if hosts is not None and hosts != world:
            raise ValueError(
                f"build_mesh: hosts={hosts} under a process group of "
                f"{world} process(es); the host axis follows the processes"
            )
        hosts = world
    d = len(devs) * world if num_shards is None else num_shards
    if hosts is not None and (hosts < 1 or d % hosts):
        raise ValueError(
            f"build_mesh: {d} shards do not split evenly over {hosts} hosts"
        )
    local = d // world
    if d < 1 or local % len(devs):
        raise ValueError(
            f"build_mesh: {local} shards do not spread evenly over "
            f"{len(devs)} device(s); the shard count must be a positive "
            "multiple of the device count"
        )
    placed = tuple(devs[i % len(devs)] for i in range(local))
    if not live:
        return Mesh(placed, hosts=hosts or 1)
    return Mesh(placed, hosts=world, first_shard=dist.get_rank() * local,
                global_size=d, distributed=True)


def axis_size(mesh: Mesh) -> int:
    """The global shard count (the reference's size of the mesh axes)."""
    return mesh.size


def num_hosts(mesh: Mesh) -> int:
    """Process rows of the mesh: the world size of a multi-process mesh,
    the ``hosts`` factor of a single-process one (1 by default)."""
    return mesh.hosts


def is_writer(mesh: Mesh) -> bool:
    """True on the one process that writes a run's shared files."""
    return mesh.rank == 0


def _stack_local(mesh: Mesh, xs: list[torch.Tensor]) -> torch.Tensor:
    """The local shards' equal-shape tensors as one contiguous
    [local, ...] buffer on the first local device, where the process
    group's collectives run."""
    dev = mesh.devices[0]
    return torch.stack([x.to(dev) for x in xs]).contiguous()


def _all_gather_stacked(mesh: Mesh, xs: list[torch.Tensor]) -> torch.Tensor:
    """[D, ...]: every global shard's tensor, on the first local device."""
    mine = _stack_local(mesh, xs)
    out = mine.new_empty((mesh.size,) + tuple(mine.shape[1:]))
    dist.all_gather_into_tensor(out, mine)
    return out


def all_to_all(mesh: Mesh, send: list[torch.Tensor]) -> list[torch.Tensor]:
    """send[i]: [D, cap, ...] rows local shard i sends to each global
    shard -> recv[j] = concat over the global shards i of their
    send[i][j] ([D * cap, ...]) on local shard j's device. On a
    single-device mesh of one process it is one stack and transpose;
    across processes the local sends are packed by destination rank into
    one buffer for one ``all_to_all_single``."""
    d = mesh.size
    tail = tuple(send[0].shape[2:])
    if mesh.distributed:
        w, loc = mesh.hosts, mesh.local_size
        cap = send[0].shape[1]
        # [src, D, cap, ...] -> [dst rank, src, dst local, cap, ...]
        buf = _stack_local(mesh, send).reshape((loc, w, loc, cap) + tail)
        buf = buf.transpose(0, 1).contiguous()
        out = torch.empty_like(buf)  # [src rank, src local, dst local, ...]
        dist.all_to_all_single(out, buf)
        out = out.reshape((d, loc, cap) + tail).transpose(0, 1)
        out = out.reshape((loc, d * cap) + tail)
        return [out[j].to(dev) for j, dev in enumerate(mesh.devices)]
    if mesh.single_device:
        t = torch.stack(send).transpose(0, 1)  # [dst, src, cap, ...]
        t = t.reshape((d, -1) + tail)
        return list(t.unbind(0))
    return [
        torch.cat([send[i][j].to(mesh.devices[j]) for i in range(d)])
        for j in range(d)
    ]


def all_gather(mesh: Mesh, xs: list[torch.Tensor]) -> torch.Tensor:
    """Concatenate the per-shard tensors of all D shards, in shard order,
    on shard 0's device; across processes every rank gets the
    concatenation on its first device (the shards' tensors must then
    have one shape)."""
    if mesh.distributed:
        out = _all_gather_stacked(mesh, xs)
        return out.reshape((-1,) + tuple(out.shape[2:]))
    return torch.cat([x.to(mesh.devices[0]) for x in xs])


def all_gather_replicated(mesh: Mesh, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The reference's ``jax.lax.all_gather``: every local shard gets the
    concatenation of all D per-shard tensors on its own device. On a
    single-device mesh it is one ``torch.cat`` shared by every shard."""
    if mesh.distributed:
        out = all_gather(mesh, xs)
        return [out.to(dev) for dev in mesh.devices]
    if mesh.single_device:
        return [torch.cat(xs)] * mesh.size
    return [torch.cat([x.to(dev) for x in xs]) for dev in mesh.devices]


def _all_reduce_max(mesh: Mesh, xs: list[torch.Tensor]) -> torch.Tensor:
    """0-d int64: the largest local scalar, reduced over the ranks (flags
    travel as integers: NCCL has no bool)."""
    t = _stack_local(mesh, [x.reshape(()).to(torch.int64) for x in xs]).max()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def any_reduce(mesh: Mesh, flags: list[torch.Tensor]) -> torch.Tensor:
    """0-d bool on shard 0's device (across processes: on every rank's
    first device): any of the D shards' flags is set (the reference's
    ``pmax`` over overflow bits)."""
    if mesh.distributed:
        return _all_reduce_max(mesh, flags) > 0
    return all_gather(mesh, [f.reshape(1) for f in flags]).any()


def max_reduce(mesh: Mesh, xs: list[torch.Tensor]) -> torch.Tensor:
    """0-d tensor on shard 0's device (across processes: on every rank's
    first device): the largest of the D per-shard integer scalars (the
    reference's ``pmax`` over int flags, e.g. overflow bitmasks)."""
    if mesh.distributed:
        return _all_reduce_max(mesh, xs)
    return all_gather(mesh, [x.reshape(1) for x in xs]).max()


def barrier(mesh: Mesh) -> None:
    """Wait until every process of the mesh has come here (nothing to wait
    for in one process)."""
    if mesh.distributed:
        flag = torch.zeros((), dtype=torch.int64, device=mesh.devices[0])
        _all_reduce_max(mesh, [flag]).item()


def gather_to_host(mesh: Mesh, xs: list[torch.Tensor]) -> list[np.ndarray]:
    """The per-shard tensors of ALL D global shards as host arrays, in
    shard order, on every process (the reference's ``process_allgather``
    pull). Across processes the shards' tensors must have one shape."""
    if mesh.distributed:
        return list(_all_gather_stacked(mesh, xs).cpu().numpy())
    return [x.cpu().numpy() for x in xs]
