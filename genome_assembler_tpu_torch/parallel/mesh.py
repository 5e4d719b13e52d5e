"""A single-process mesh of D shards and its collectives.

Counterpart of ``genome_assembler_tpu/parallel/mesh.py``. The reference
rides ``jax.sharding.Mesh`` + ``shard_map`` with XLA collectives; here a
mesh is D shards driven by one process, each shard a ``torch.device``.
Shards are placed round-robin over an explicit device list, so one H100
can hold four shards (``build_mesh(4)``) and a four-GPU host holds one
shard per card with the same call. The collectives are plain functions
over per-shard tensors (a list, one entry per shard, each on its shard's
device). Multi-process ``torch.distributed`` meshes are not built here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import resolve_device


class Mesh(NamedTuple):
    """D shards; ``devices[i]`` is the device of shard i."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def single_device(self) -> bool:
        """True when every shard sits on one device."""
        return len(set(self.devices)) == 1

    def __str__(self) -> str:
        distinct = list(dict.fromkeys(str(d) for d in self.devices))
        return f"{self.size} shard(s) on {', '.join(distinct)}"


def build_mesh(
    num_shards: int | None = None,
    devices: list[str | torch.device] | None = None,
) -> Mesh:
    """D shards round-robin over ``devices``.

    devices defaults to every visible CUDA device; without one this
    raises (the mesh never carries on on the CPU unless the caller names
    it, e.g. ``devices=["cpu"]``). num_shards defaults to the number of
    devices and must be a multiple of it.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_mesh: CUDA is not available on this machine and no "
                "device list was given (no fallback to the CPU)"
            )
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("build_mesh: empty device list")
    d = len(devs) if num_shards is None else num_shards
    if d < 1 or d % len(devs):
        raise ValueError(
            f"build_mesh: {d} shards do not spread evenly over "
            f"{len(devs)} device(s); the shard count must be a positive "
            "multiple of the device count"
        )
    return Mesh(tuple(devs[i % len(devs)] for i in range(d)))


def axis_size(mesh: Mesh) -> int:
    """Shard count (the reference's size of the mesh axis)."""
    return mesh.size


def num_hosts(mesh: Mesh) -> int:
    """Hosts the mesh spans: one process, so always 1."""
    return 1


def scatter_rows(mesh: Mesh, host: torch.Tensor, rows: int) -> list[torch.Tensor]:
    """Upload a [D*rows, ...] host tensor; shard i gets rows
    [i*rows, (i+1)*rows) on its device. A single-device mesh uploads once
    and hands out contiguous row views."""
    if mesh.single_device:
        whole = host.to(mesh.devices[0])
        return [whole[i * rows : (i + 1) * rows] for i in range(mesh.size)]
    return [
        host[i * rows : (i + 1) * rows].to(dev)
        for i, dev in enumerate(mesh.devices)
    ]


def all_to_all(mesh: Mesh, send: list[torch.Tensor]) -> list[torch.Tensor]:
    """send[i]: [D, cap, ...] rows shard i sends to each shard ->
    recv[j] = concat over i of send[i][j] ([D * cap, ...]) on shard j's
    device. On a single-device mesh it is one stack and transpose."""
    d = mesh.size
    if mesh.single_device:
        t = torch.stack(send).transpose(0, 1)  # [dst, src, cap, ...]
        t = t.reshape((d, -1) + tuple(send[0].shape[2:]))
        return list(t.unbind(0))
    return [
        torch.cat([send[i][j].to(mesh.devices[j]) for i in range(d)])
        for j in range(d)
    ]


def all_gather(mesh: Mesh, xs: list[torch.Tensor]) -> torch.Tensor:
    """Concatenate per-shard tensors on shard 0's device."""
    return torch.cat([x.to(mesh.devices[0]) for x in xs])


def all_gather_replicated(mesh: Mesh, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The reference's ``jax.lax.all_gather``: every shard gets the
    concatenation of the per-shard tensors on its own device. On a
    single-device mesh it is one ``torch.cat`` shared by every shard."""
    if mesh.single_device:
        return [torch.cat(xs)] * mesh.size
    return [torch.cat([x.to(dev) for x in xs]) for dev in mesh.devices]


def any_reduce(mesh: Mesh, flags: list[torch.Tensor]) -> torch.Tensor:
    """0-d bool on shard 0's device: any shard's flag is set (the
    reference's ``pmax`` over overflow bits)."""
    return all_gather(mesh, [f.reshape(1) for f in flags]).any()


def max_reduce(mesh: Mesh, xs: list[torch.Tensor]) -> torch.Tensor:
    """0-d tensor on shard 0's device: the largest per-shard scalar (the
    reference's ``pmax`` over int flags, e.g. overflow bitmasks)."""
    return all_gather(mesh, [x.reshape(1) for x in xs]).max()
