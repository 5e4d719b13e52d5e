"""One rank of a multi-process acceptance point.

``models/acceptance.py`` with ``multiprocess=True`` starts this module as
D processes through ``parallel/launch.py::spawn`` (a rank a shard; on
cards, a card a rank): the parent simulates the reads once, saves them as
one ``.npy`` that every rank maps, and keeps the host reference; a rank
runs the port's own sharded entry points over the process group and
leaves what the parent checks:

  count     (an untimed pass with ``--warm``, then) the timed
            ``distributed_count_table``, closed by a device synchronise
            and a barrier, so the seconds are the slowest rank's; rank 0
            writes ``OUT.table.npz`` (the gathered table's counted rows
            in the reference layout) and ``OUT.json``;
  assemble  ``assemble_distributed`` and ``assemble_distributed_sharded``;
            every rank writes ``OUT.rank<r>.json`` (both contig lists,
            the wall seconds, the sharded run's metrics, the extraction
            kernel's launches).

    python -m genome_assembler_tpu_torch.models.acceptance_rank count \\
        --reads reads.npy -k 31 --devices 4 --capacity 18874368 \\
        --out /tmp/p4 --device cuda
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..ops import count_torch
from ..ops.kmer_torch import extract_canonical_flat, pack_on_device
from ..parallel.mesh import barrier, build_mesh, init_distributed
from ..parallel.mesh import shutdown_distributed
from ..parallel.pipeline import (
    assemble_distributed,
    assemble_distributed_sharded,
    distributed_count_table,
)
from ..utils.config import AssemblyConfig
from ..utils.device import resolve_device, synchronize
from ..utils.metrics import Metrics


def _job_count(args, reads, cfg, mesh) -> None:
    def count():
        barrier(mesh)
        t0 = time.perf_counter()
        table = distributed_count_table(reads, cfg, mesh,
                                        table_capacity=args.capacity)
        synchronize(mesh.devices[0])
        barrier(mesh)
        return table, time.perf_counter() - t0

    if args.warm:
        count()
    table, seconds = count()
    if mesh.rank == 0:
        num = int(table.num_unique)
        words, counts, _, overflow = count_torch.count_table_to_numpy(
            table._replace(limbs=table.limbs[:num], counts=table.counts[:num]),
            cfg.k,
        )
        np.savez(args.out + ".table.npz", words=words, counts=counts)
        with open(args.out + ".json", "w") as fh:
            json.dump({"seconds": seconds, "num_unique": num,
                       "overflow": bool(overflow), "ranks": mesh.hosts}, fh)
    barrier(mesh)


def _job_assemble(args, reads, cfg, mesh) -> None:
    m = Metrics()
    t0 = time.perf_counter()
    contigs = assemble_distributed(reads, cfg, mesh,
                                   table_capacity=args.capacity)
    sharded = assemble_distributed_sharded(
        reads, cfg, mesh, table_capacity=args.capacity, metrics=m)
    wall = time.perf_counter() - t0
    with open(f"{args.out}.rank{mesh.rank}.json", "w") as fh:
        json.dump({
            "contigs": contigs, "sharded": sharded, "wall_s": wall,
            "metrics": m.report(),
            "kernel_launches": extract_canonical_flat.launches,
            "pack_launches": pack_on_device.launches,
        }, fh)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("job", choices=["count", "assemble"])
    p.add_argument("--reads", required=True,
                   help="[B, L] uint8 codes as .npy; every rank maps it")
    p.add_argument("-k", type=int, required=True)
    p.add_argument("--devices", type=int, required=True,
                   help="the global shard count")
    p.add_argument("--capacity", type=int, required=True)
    p.add_argument("--warm", action="store_true")
    p.add_argument("--out", required=True, help="prefix of the result files")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    init_distributed("gloo" if device.type == "cpu" else "nccl")
    mesh = build_mesh(args.devices,
                      devices=None if args.device == "cuda" else [device])
    reads = np.load(args.reads, mmap_mode="r")
    cfg = AssemblyConfig(k=args.k, read_len=reads.shape[1])
    (_job_count if args.job == "count" else _job_assemble)(
        args, reads, cfg, mesh)
    shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
