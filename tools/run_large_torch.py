#!/usr/bin/env python3
"""Beyond the acceptance configs: assemble a large simulated genome on one
GPU (the port of ``tools/run_large.py``).

    python3 tools/run_large_torch.py [genome_Mb] [coverage] [k] [stride]
                                     [--reps N] [--device cuda|cpu]
                                     [--trace-dir DIR]

Defaults: 40 Mb, 25x, k=31, no merge stride, one warm run, on the card
(an error without CUDA; ``--device cpu`` runs the plain torch versions).
The genome (seed 7001) and its 100 bp reads (seed 7002, tiled for k) are
``run_large.py``'s, and so is the table capacity,
``snug_capacity(1.2 x genome + 4096)``: at 40 Mb, 10,000,000 reads,
700,000,000 windows and 50,331,648 table rows, so a merge sorts the
table and one batch, 68,681,728 rows, and ``bucketed="auto"`` takes the
hash buckets. One cold ``assemble_torch`` runs, then ``--reps`` warm ones.

Prints one JSON line with ``run_large.py``'s keys (``genome_mb``,
``coverage``, ``k``, ``reads``, ``windows``, ``cold_s``, ``warm_s``,
``reads_per_s``, ``stages_s`` of the best warm run, ``warm_runs``,
``contigs``, ``n50``, ``exact_single_contig``, ``exact_kmer_content``)
and adds the card (``nvidia-smi``'s name and power limit), the peak
device memory of the process (``peak_gib``, null on the CPU) and of its
host memory (``host_peak_gib``; ``sim_host_peak_gib`` once the reads are
simulated), the kernel's build (``build_s``, before
the cold run), the extraction and the pack kernel's launches over the
cold and warm runs (``extract_launches``, ``pack_launches``), and the streamed table's layout: the merge stride the count
recorded in its metrics, the rows a merge sorts at it, and whether
``auto`` took the buckets there. With ``--trace-dir DIR`` one more warm
run goes under ``torch.profiler`` (``utils/metrics.py::profiler_trace``,
the trace left in DIR), and ``traced`` gives its stage seconds and the
device's busy seconds in each stage (``read_trace(DIR).busy_share``).

``exact_kmer_content`` is ``host/traverse.py::kmer_content_equal``
computed on the device (``kmer_content_equal_device``): the host version
takes minutes at 40 Mb.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np
import torch

# the checkout's root, so that the port imports without an install
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from genome_assembler_tpu_torch.host.stats import contig_stats
from genome_assembler_tpu_torch.host.traverse import contigs_equal
from genome_assembler_tpu_torch.models.pipeline import (
    assemble_torch,
    pack_on_device,
    use_bucketed,
)
from genome_assembler_tpu_torch.ops import _build, count_torch
from genome_assembler_tpu_torch.ops import kmer_torch as kmer
from genome_assembler_tpu_torch.utils.config import AssemblyConfig
from genome_assembler_tpu_torch.utils.device import (
    card_line,
    resolve_device,
)
from genome_assembler_tpu_torch.utils.dna import (
    INVALID_CODE,
    decode_seq,
    encode_seq,
)
from genome_assembler_tpu_torch.utils.keys import (
    n_limbs,
    snug_capacity,
)
from genome_assembler_tpu_torch.utils.metrics import (
    Metrics,
    profiler_trace,
    read_trace,
)
from genome_assembler_tpu_torch.utils.simulate import (
    simulate_genome,
    simulate_reads,
)

READ_LEN = 100
ROW_WINDOWS = 4096  # windows a row when a sequence is cut for the kernel


def canonical_keys(seq: str, k: int, dev: torch.device) -> torch.Tensor:
    """[len(seq) - k + 1, n_limbs] canonical keys of every window of an
    ACGT sequence, in window order, by the extraction kernel on a card (its
    plain version on the CPU). The sequence is cut into rows of
    ``ROW_WINDOWS`` windows that overlap by k - 1 bases; the last row is
    padded with Ns, whose windows come last and are dropped. Raises on a
    base other than ACGT, as the host check does."""
    codes = encode_seq(seq)
    n_win = len(codes) - k + 1
    if n_win <= 0:
        return torch.empty((0, n_limbs(k)), dtype=torch.int64, device=dev)
    rows = -(-n_win // ROW_WINDOWS)
    padded = np.full(rows * ROW_WINDOWS + k - 1, INVALID_CODE, np.uint8)
    padded[: len(codes)] = codes
    cut = np.lib.stride_tricks.as_strided(
        padded, (rows, ROW_WINDOWS + k - 1), (ROW_WINDOWS, 1))
    packed, inv, flag = pack_on_device(
        torch.from_numpy(np.ascontiguousarray(cut)).to(dev))
    keys = kmer.extract_canonical_flat(packed, ROW_WINDOWS + k - 1, k,
                                       inv_bits=inv, flag=flag)
    return keys[:n_win]


def unique_keys(keys: torch.Tensor) -> torch.Tensor:
    """The sorted distinct rows of [N, n_limbs] keys."""
    table = count_torch.count_keys(keys)
    return table.limbs[: int(table.num_unique)]


def kmer_content_equal_device(contigs: list[str], genome: str, k: int,
                              dev: torch.device) -> bool:
    """``host.traverse.kmer_content_equal`` on ``dev``: the contigs spell
    exactly the genome's canonical k-mer set, and no more windows than the
    genome has."""
    want = unique_keys(canonical_keys(genome, k, dev))
    parts = [canonical_keys(c, k, dev) for c in contigs if len(c) >= k]
    if not parts:
        return want.shape[0] == 0
    got = unique_keys(torch.cat(parts))
    if got.shape != want.shape or not torch.equal(got, want):
        return False
    spelled = sum(len(c) - k + 1 for c in contigs if len(c) >= k)
    return spelled <= len(genome) - k + 1


def host_peak_gib() -> float:
    """The process's peak resident memory on the host so far (Linux
    reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="assemble a large simulated genome on one device"
    )
    ap.add_argument("genome_mb", nargs="?", type=float, default=40.0)
    ap.add_argument("coverage", nargs="?", type=float, default=25.0)
    ap.add_argument("k", nargs="?", type=int, default=31)
    ap.add_argument("stride", nargs="?", type=int, default=None,
                    help="merge stride (default: none)")
    ap.add_argument("--reps", type=int, default=1, help="warm runs")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without CUDA) or cpu")
    ap.add_argument("--trace-dir", default=None,
                    help="one more warm run under torch.profiler, its trace "
                    "written here and read back")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    card = card_line(dev)
    build_s = None
    if on_card:
        t0 = time.perf_counter()
        _build.kmer_extract_fn()
        build_s = time.perf_counter() - t0
    k = args.k
    glen = int(args.genome_mb * 1e6)
    t0 = time.perf_counter()
    genome = simulate_genome(glen, seed=7001)
    rs = simulate_reads(genome, coverage=args.coverage, read_len=READ_LEN,
                        seed=7002, tile_k=k)
    sim_s = time.perf_counter() - t0
    sim_host_gib = host_peak_gib()
    cfg = AssemblyConfig(k=k, read_len=READ_LEN)
    cap = snug_capacity(int(1.2 * glen) + 4096)
    print(f"# genome {args.genome_mb} Mb, {rs.num_reads} reads, cap "
          f"{cap / 1e6:.0f}M, sim {sim_s:.0f}s", file=sys.stderr, flush=True)

    kmer.extract_canonical_flat.launches = kmer.pack_on_device.launches = 0

    def assemble(metrics):
        return assemble_torch(rs.codes, cfg, device=dev, metrics=metrics,
                              table_capacity=cap, merge_stride=args.stride)

    m_cold = Metrics()
    t0 = time.perf_counter()
    assemble(m_cold)
    cold_s = time.perf_counter() - t0
    warm_runs = []
    for _ in range(max(1, args.reps)):
        m = Metrics()
        t0 = time.perf_counter()
        contigs = assemble(m)
        warm_runs.append((time.perf_counter() - t0, m))
    warm_s, m = min(warm_runs, key=lambda wm: wm[0])
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None
    launches = kmer.extract_canonical_flat.launches
    pack_launches = kmer.pack_on_device.launches

    # the layout the count took: its recorded stride (1 unless a stride
    # was asked for) and the reference's bound on the rows of one merge
    stride = int(m.counters.get("merge_stride", 1))
    merge_rows = cap + stride * cfg.batch_reads * (READ_LEN - k + 1)

    traced = None
    if args.trace_dir:
        m_traced = Metrics()
        with profiler_trace(args.trace_dir):
            assemble(m_traced)
        trace = read_trace(args.trace_dir)
        traced = {"stages_s": dict(m_traced.stages), "device_busy_s": {
            name: trace.busy_share(name)[0] for name in m_traced.stages}}

    t0 = time.perf_counter()
    gstr = decode_seq(genome)
    exact_single = contigs_equal(contigs, [gstr])
    exact_content = kmer_content_equal_device(contigs, gstr, k, dev)
    check_s = time.perf_counter() - t0
    stats = contig_stats(contigs)
    return {
        "genome_mb": args.genome_mb,
        "coverage": args.coverage,
        "k": k,
        "reads": rs.num_reads,
        "windows": rs.num_reads * (READ_LEN - k + 1),
        "cold_s": cold_s,
        "warm_s": warm_s,
        "reads_per_s": rs.num_reads / warm_s,
        "stages_s": dict(m.stages),
        "warm_runs": [{"warm_s": w, "stages_s": dict(mm.stages)}
                      for w, mm in warm_runs],
        "contigs": stats["contigs"],
        "n50": stats["n50"],
        "exact_single_contig": exact_single,
        "exact_kmer_content": exact_content,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "card": card,
        "build_s": build_s,
        "sim_s": sim_s,
        "check_s": check_s,
        "table_capacity": cap,
        "merge_stride": stride,
        "merge_rows": merge_rows,
        "bucketed": use_bucketed("auto", merge_rows),
        "peak_gib": peak,
        "sim_host_peak_gib": sim_host_gib,
        "host_peak_gib": host_peak_gib(),
        "extract_launches": launches,
        "pack_launches": pack_launches,
        "traced": traced,
    }


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
