#!/usr/bin/env python3
"""Deferred merges on one card, with order effects ruled out: the flat
count of CFG-4's reads at merge strides 1, 2, 4 and 8.

    PYTHONPATH=. python3 tools/probe_stride.py [--rounds 4] [--seed 0] \
        [--out chiprun_out/probe_stride.json]

Builds the extraction kernel and simulates CFG-4's reads (12,000,000 bp,
100x, seeds 1050/1051) as ``chip_smoke.py`` does. After one warm count it
runs ``--rounds`` rounds; each round times one ``count_reads_device(
bucketed="off", merge_stride=s)`` for every stride, in an order shuffled
by ``--seed`` anew each round, and holds every table bit-equal to the
stride-1 one. A stride's "vs_stride1" is its time minus stride 1's in the
same round (the repeated pairs). Then one count at stride 2 and one at
stride 8 run under ``torch.profiler``; each prints its device time by
kernel group (the extraction kernel, sorts, the rest) and its device-busy
share of the wall time. It prints the card's name and power limit first
and writes every row to ``--out``. It needs CUDA and never runs on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

import chip_smoke as smoke
import genome_assembler_tpu_torch.reference as ref
from genome_assembler_tpu_torch.models import pipeline
from genome_assembler_tpu_torch.ops import _build, kmer_torch as kmer
from genome_assembler_tpu_torch.utils.keys import snug_capacity

STRIDES = (1, 2, 4, 8)


def kernel_group(name: str) -> str:
    if "extract_canonical" in name:
        return "extract"
    low = name.lower()
    if "sort" in low or "radix" in low:
        return "sort"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/probe_stride.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_stride: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smoke.card_info(torch)
    _build.kmer_extract_fn()
    t0 = time.perf_counter()
    g4 = ref.simulate_genome(12_000_000, seed=1050)
    reads = ref.simulate_reads(g4, coverage=100, read_len=100,
                               seed=1051).codes
    cfg = ref.AssemblyConfig(k=31, read_len=100)
    capacity = snug_capacity(int(1.5 * 12_000_000) + 4096)
    smoke.log(f"inputs simulated in {time.perf_counter() - t0:.1f} s")

    def count(stride):
        return pipeline.count_reads_device(
            reads, cfg, device=dev, table_capacity=capacity, bucketed="off",
            merge_stride=stride)

    base, _, _, _ = smoke.timed_count(torch, lambda: count(1), kmer, [dev])
    rng = np.random.default_rng(args.seed)
    rows = []
    for rnd in range(args.rounds):
        order = [int(s) for s in rng.permutation(STRIDES)]
        secs = {}
        for pos, stride in enumerate(order):
            t, secs[stride], _, peak = smoke.timed_count(
                torch, lambda: count(stride), kmer, [dev])
            smoke.check(smoke.tables_bit_equal(torch, t, base),
                        f"stride {stride}: table != stride 1's")
            rows.append({"round": rnd, "position": pos, "stride": stride,
                         "count_s": secs[stride], "peak_gib": peak})
            del t
        for r in rows[-len(STRIDES):]:
            r["vs_stride1"] = round(r["count_s"] - secs[1], 4)
            print(json.dumps(r), flush=True)
    summary = {
        s: sorted(r["count_s"] for r in rows if r["stride"] == s)
        for s in STRIDES
    }
    print(json.dumps({"count_s_by_stride": summary}), flush=True)

    splits = []
    for stride in (2, 8):
        torch.cuda.synchronize(dev)
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            w0 = time.perf_counter()
            count(stride)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - w0
        groups: dict[str, float] = {}
        top = []
        for e in prof.key_averages():
            us = e.self_device_time_total
            if us <= 0:
                continue
            g = kernel_group(e.key)
            groups[g] = groups.get(g, 0.0) + us / 1e6
            top.append((us / 1e6, e.count, e.key[:80]))
        busy = sum(groups.values())
        split = {"stride": stride, "wall_s": round(wall, 4),
                 "device_s": {g: round(v, 4) for g, v in groups.items()},
                 "device_busy_share": round(busy / wall, 4),
                 "top": [[round(s_, 4), n, k] for s_, n, k in
                         sorted(top, reverse=True)[:8]]}
        splits.append(split)
        print(json.dumps(split), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"rows": rows, "count_s_by_stride": summary,
                       "splits": splits}, fh, indent=1)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except smoke.SmokeFailure as e:
        print(f"probe_stride: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
