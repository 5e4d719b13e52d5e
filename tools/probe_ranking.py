#!/usr/bin/env python3
"""The single-device ranking's phases on CFG-2, and phase 14's rank job.

    PYTHONPATH=. python3 tools/probe_ranking.py [--ranks] [--out FILE]

(i) CFG-2 at full size (4,641,652 bp, 50x, 100 bp reads, k=31) counted,
    filtered and linked on one card, then the ranking of its 9.4M edge
    rows: phase A (``_phase_a``), phases B + C (``_phases_bc``), the whole
    sampled ranking (``_resolve_chains``) and the exact pass
    (``_resolve_chains(exact=True)``), each the mean ms of 10 warm calls
    between CUDA events, with the rounds of phases A and B. Phase B's
    loops read the host, so the events hold those reads too.
(ii) With ``--ranks``: CFG-4's reads (12,000,000 bp, 100x, the smoke's
    seeds) through ``chip_smoke.py --rank-compress``, the job that
    ``chip_smoke.py`` phase 14 starts where more than one card is visible,
    as min(4, cards) NCCL ranks, and its JSON: the sharded compress,
    sampled and forced exact, outputs equal or not.

It prints one JSON line a measurement and ``--out`` keeps them all. It
needs CUDA and never runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

import genome_assembler_tpu_torch.reference as ref
from genome_assembler_tpu_torch.models import pipeline
from genome_assembler_tpu_torch.ops import count_torch, unitig_torch
from genome_assembler_tpu_torch.parallel import launch
from genome_assembler_tpu_torch.utils.keys import snug_capacity

K, REPS = 31, 10
SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chip_smoke.py")


def mean_ms(fn) -> float:
    """Mean ms per call over REPS calls, after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return round(start.elapsed_time(end) / REPS, 4)


def measure_cfg2(emit) -> None:
    glen, seed = 4_641_652, 1030
    genome = ref.simulate_genome(glen, seed=seed)
    rs = ref.simulate_reads(genome, coverage=50, read_len=100, seed=seed + 1,
                            tile_k=K)
    cfg = ref.AssemblyConfig(k=K, read_len=100)
    dev = torch.device("cuda", 0)
    t = pipeline.count_reads_device(
        rs.codes, cfg, device=dev,
        table_capacity=snug_capacity(int(1.1 * glen) + 4096))
    t = count_torch.compact_table(t)
    t = count_torch.compact_table(count_torch.filter_table(
        t, cfg.min_count or pipeline.auto_min_count(t)))
    edges, _, valid = unitig_torch._build_edges(t, K)
    prev = unitig_torch._link_sortjoin(edges, valid, K)
    rounds = {}
    _, _, ok = unitig_torch._rank_sampled(prev, rounds)
    anc, dist, _, _ = unitig_torch._phase_a(prev)
    emit({"probe": "cfg2_ranking", "edge_rows": int(prev.shape[0]),
          "sampled_ok": bool(ok), "rounds": rounds, "reps": REPS,
          "phase_a_ms": mean_ms(lambda: unitig_torch._phase_a(prev)),
          "phases_bc_ms": mean_ms(
              lambda: unitig_torch._phases_bc(prev, anc, dist)),
          "sampled_ms": mean_ms(
              lambda: unitig_torch._resolve_chains(prev, valid)),
          "exact_ms": mean_ms(
              lambda: unitig_torch._resolve_chains(prev, valid, exact=True))})


def measure_ranks(emit) -> None:
    glen = 12_000_000
    genome = ref.simulate_genome(glen, seed=1050)
    rs = ref.simulate_reads(genome, coverage=100, read_len=100, seed=1051)
    ranks = min(4, torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as tmp:
        reads_file = os.path.join(tmp, "cfg4_reads.txt")
        out = os.path.join(tmp, "rank_compress.json")
        launch.write_reads_lines(reads_file, rs.codes)
        del rs
        res = launch.spawn(
            ranks, [reads_file, out, str(snug_capacity(int(1.5 * glen) + 4096))],
            device="cuda", timeout_s=600.0, entry=(SMOKE, "--rank-compress"))
        if not res.ok:
            raise RuntimeError(res.describe())
        with open(out) as fh:
            emit({"probe": "rank_compress", "cards": ranks, **json.load(fh)})


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=None, help="keep the rows as JSON here")
    p.add_argument("--ranks", action="store_true",
                   help="also measurement (ii), across the cards")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("probe_ranking: CUDA is not available", file=sys.stderr)
        return 1
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

    measure_cfg2(emit)
    if args.ranks:
        torch.cuda.empty_cache()  # rank 0 shares card 0 with this process
        measure_ranks(emit)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
