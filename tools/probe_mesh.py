#!/usr/bin/env python3
"""Two measurements on the card that order the next modules to port.

    PYTHONPATH=. python3 tools/probe_mesh.py [--out FILE] [--quick] [--rounds-only]

(i) The sharded graph's ``compress`` with a rank a card: an error-free
    genome of 3, 6 and 12 Mb (CFG-4's size) at 30x in 100 bp reads, k=31,
    4 shards over 1, 2 and 4 NCCL ranks (as many as there are cards; one
    rank holds all 4 shards on one card). Each rank counts, filters and
    then runs ``make_sharded_compress`` three times with the sampled
    two-level ranking and three times with the exact pass forced
    (``_exact=True``), after a warm-up of each, and checks that both give
    the same per-shard outputs; rank 0 reports, for each pass, the
    seconds of the stage, the query rounds, the doubling rounds and the
    seconds of one doubling round beside the edge rows a card holds. This
    says whether a round's time follows the rows a card holds (then more
    cards shorten the rounds) or the round's fixed costs (then only fewer
    rounds help), and what the sampled ranking's fewer rounds buy.
(ii) ``torch.sort`` of random int64 keys at 26M, 50M and 100M rows on one
    card, CUDA events over three sorts after a warm-up: nanoseconds a row.
    A cliff between two sizes is what the reference's bucketed streaming
    merge exists for.

(iii) The CFG-4 count alone at full size (12,000,000 reads of 100 bp,
    k=31) on d shards over d NCCL ranks, d in 1, 2, 4 up to the cards
    there are: ``models/acceptance_rank.py count --warm``, the timed
    ``distributed_count_table`` of the slowest rank after an untimed
    pass; the rates and their weak-scaling efficiency are those that
    ``ga-torch accept 4 --multiprocess`` reports, without its host
    reference count.

The probe starts its own ranks (this file with ``--rank-job``) through
``parallel/launch.py::spawn``. It prints one JSON line a measurement and
``--out`` keeps them all. It needs CUDA and never runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from genome_assembler_tpu_torch.ops import count_torch
from genome_assembler_tpu_torch.parallel import compress as pc
from genome_assembler_tpu_torch.parallel import mesh as mesh_mod
from genome_assembler_tpu_torch.parallel import pipeline as pp
from genome_assembler_tpu_torch.parallel.launch import spawn
from genome_assembler_tpu_torch.utils.config import AssemblyConfig
from genome_assembler_tpu_torch.utils.device import synchronize
from genome_assembler_tpu_torch.utils.keys import snug_capacity
from genome_assembler_tpu_torch.utils.simulate import (
    simulate_genome,
    simulate_reads,
)

K, D, REPS = 31, 4, 3


def rank_job(args) -> int:
    """One rank of measurement (i); rank 0 writes the JSON row."""
    mesh_mod.init_distributed("nccl", timeout_s=300.0)
    mesh = mesh_mod.build_mesh(D)
    reads = np.load(args.reads, mmap_mode="r")
    cfg = AssemblyConfig(k=K, read_len=reads.shape[1])
    tables = pp._run_distributed_step(reads, cfg, mesh,
                                      table_capacity=args.capacity)
    tables = pp._shard_filter_compact(tables, 1)
    kept = int(mesh_mod.max_reduce(mesh, [t.num_unique for t in tables]))
    c_shard = snug_capacity(kept)
    tables = [count_torch.resize_table(t, c_shard) for t in tables]
    runs, outputs = {}, {}
    for name in ("sampled", "exact"):
        step = pc.make_sharded_compress(mesh, K, c_shard, _exact=name == "exact")
        runs[name] = []
        for _ in range(REPS + 1):  # the first is the warm-up
            for dev in mesh.devices:
                synchronize(dev)
            mesh_mod.barrier(mesh)
            t0 = time.perf_counter()
            g = step(tables)
            for dev in mesh.devices:
                synchronize(dev)
            mesh_mod.barrier(mesh)
            runs[name].append({
                "compress_s": time.perf_counter() - t0,
                "rank_pass": g.rank_pass,
                "query_rounds": g.query_rounds,
                "doubling_rounds": g.doubling_rounds,
                "s_a_doubling_round": g.doubling_seconds / max(
                    g.doubling_rounds, 1),
            })
            if g.overflow:
                raise RuntimeError(f"compress overflow bits {g.overflow}")
        runs[name] = runs[name][1:]
        outputs[name] = g
    g, ge = outputs["sampled"], outputs["exact"]
    differ = [
        not all(torch.equal(getattr(g, f)[i], getattr(ge, f)[i])
                for f in ("valid", "uid", "pos", "heads"))
        for i in range(mesh.local_size)
    ]
    differ = bool(mesh_mod.any_reduce(mesh, [
        torch.tensor(x, device=dev) for x, dev in zip(differ, mesh.devices)]))
    if mesh.rank == 0:
        with open(args.out, "w") as fh:
            json.dump({
                "ranks": mesh.hosts, "shards": D, "c_shard": c_shard,
                "kept_kmers_largest_shard": kept,
                "edge_rows_a_card": mesh.local_size * 2 * c_shard,
                "edge_rows_global": D * 2 * c_shard,
                "unitigs": g.num_unitigs,
                "sampled_equals_exact": not differ
                and g.num_unitigs == ge.num_unitigs,
                "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2),
                "runs": runs,
            }, fh)
    mesh_mod.shutdown_distributed()
    return 0


def measure_rounds(genome_lens, emit) -> None:
    cards = torch.cuda.device_count()
    worlds = [w for w in (1, 2, 4) if w <= cards]
    with tempfile.TemporaryDirectory() as tmp:
        for glen in genome_lens:
            genome = simulate_genome(glen, seed=1050)
            rs = simulate_reads(genome, coverage=30, read_len=100, seed=1051)
            path = os.path.join(tmp, f"reads{glen}.npy")
            np.save(path, rs.codes)
            capacity = snug_capacity(int(1.5 * glen) + 4096)
            for world in worlds:
                out = os.path.join(tmp, f"row{glen}_{world}.json")
                res = spawn(
                    world,
                    ["--rank-job", "--reads", path, "--capacity",
                     str(capacity), "--out", out],
                    device="cuda", timeout_s=600.0,
                    entry=(os.path.abspath(__file__),),
                )
                if not res.ok:
                    raise RuntimeError(res.describe())
                with open(out) as fh:
                    emit({"probe": "compress_rounds", "genome_len": glen,
                          "reads": rs.num_reads, "cards": cards,
                          **json.load(fh)})
            os.unlink(path)


def measure_count(emit) -> None:
    from genome_assembler_tpu_torch.models.acceptance import (
        weak_scaling_efficiency,
    )

    cards = torch.cuda.device_count()
    glen = 12_000_000
    genome = simulate_genome(glen, seed=1050)
    rs = simulate_reads(genome, coverage=100, read_len=100, seed=1051)
    capacity = snug_capacity(int(1.5 * glen) + 4096)
    rates = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reads.npy")
        np.save(path, rs.codes)
        for d in (1, 2, 4):
            if d > cards:
                break
            out = os.path.join(tmp, f"count{d}")
            res = spawn(
                d,
                ["count", "--reads", path, "-k", str(K), "--devices", str(d),
                 "--capacity", str(capacity), "--out", out, "--warm"],
                device="cuda", timeout_s=600.0,
                entry=("-m",
                       "genome_assembler_tpu_torch.models.acceptance_rank"),
            )
            if not res.ok:
                raise RuntimeError(res.describe())
            with open(out + ".json") as fh:
                info = json.load(fh)
            rates[d] = rs.num_reads / info["seconds"]
            emit({"probe": "cfg4_count_ranks", "ranks": d, "shards": d,
                  "reads": rs.num_reads, "cards": cards, **info})
    emit({"probe": "cfg4_count_weak_scaling",
          "reads_per_s": {str(d): round(r, 1) for d, r in rates.items()},
          "efficiency": {str(d): round(e, 3) for d, e in
                         weak_scaling_efficiency(rates).items()}})


def measure_sort(sizes, emit) -> None:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    for n in sizes:
        keys = torch.randint(0, 2**62, (n,), dtype=torch.int64, device=dev,
                             generator=gen)
        torch.sort(keys)
        torch.cuda.synchronize(dev)
        ms = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.sort(keys)
            end.record()
            torch.cuda.synchronize(dev)
            ms.append(start.elapsed_time(end))
        emit({"probe": "torch_sort_int64", "rows": n,
              "ms": [round(x, 3) for x in ms],
              "ns_a_row": [round(x * 1e6 / n, 4) for x in ms],
              "peak_gib": round(torch.cuda.max_memory_allocated(dev) / 2**30,
                                2)})
        del keys
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=None, help="keep the rows as JSON here")
    p.add_argument("--quick", action="store_true",
                   help="the 12 Mb genome only, and the sort")
    p.add_argument("--rounds-only", action="store_true",
                   help="measurement (i) alone")
    p.add_argument("--rank-job", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--reads", default=None, help=argparse.SUPPRESS)
    p.add_argument("--capacity", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("probe_mesh: CUDA is not available", file=sys.stderr)
        return 1
    if args.rank_job:
        return rank_job(args)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    rows = [{"probe": "cards", "nvidia_smi": smi.stdout.strip().splitlines(),
             "torch": torch.__version__, "cuda": torch.version.cuda}]
    print(json.dumps(rows[0]), flush=True)

    from genome_assembler_tpu_torch.ops import _build

    _build.build("kmer_extract")  # once here, so that no rank builds it

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    if not args.rounds_only:
        measure_sort([26_000_000, 50_000_000, 100_000_000], emit)
    measure_rounds([12_000_000] if args.quick
                   else [3_000_000, 6_000_000, 12_000_000], emit)
    if not args.rounds_only:
        measure_count(emit)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
