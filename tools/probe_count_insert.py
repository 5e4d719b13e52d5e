#!/usr/bin/env python3
"""Probe of the count insert kernel (``count_insert_kernel`` in
``csrc/kmer_extract.cu``) on one GPU.

    PYTHONPATH=. python3 tools/probe_count_insert.py [--reps N] [--out FILE]

Prints the card's name and power limit and what ``ptxas -v`` says of the
library's kernels, then, for the single-card cells' tables (capacity
5,242,880, E. coli, and 20,971,520, yeast), inserts batches of
18,350,080 keys (262,144 reads x 70 windows at k=31) drawn from a
genome's worth of unique keys (4.64M and 12.16M random 62-bit keys, so
each key is seen about 70 times in 47 batches at yeast's 100x, as in an
assembly). Each row gives the mean time per batch from CUDA events,
the kernel's own device time from ``torch.profiler``, the byte bound
(``count_hash_torch.insert_bound_ms``) and, for the same batch, the flat
sort merge that the card ran before (``count_torch.merge_raw_keys`` into
a table of the same capacity holding the same keys). Cases:

  * ``steady``: every key already in the table (the assembly's later
    batches, where each insert only adds);
  * ``first``: the first batch into an empty table (claims; the table is
    emptied between launches, outside the timed events);
  * ``finish``: ``hash_to_table``, the one sort of a stream.

The table after one batch is checked against ``merge_raw_keys`` at full
size before anything is timed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH_KEYS = 262_144 * 70
CELLS = (("ecoli_k12_k31", 5_242_880, 4_641_652),
         ("yeast_s288c_k31", 20_971_520, 12_157_105))


def main() -> int:
    import torch

    import chip_smoke as cs
    from genome_assembler_tpu_torch.ops import _build
    from genome_assembler_tpu_torch.ops import count_hash_torch as ch
    from genome_assembler_tpu_torch.ops import count_torch
    from genome_assembler_tpu_torch.utils.keys import SENTINEL

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None,
                    help="also write the rows to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_count_insert: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cs.card_info(torch)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    src = os.path.join(_build.CSRC_DIR, "kmer_extract.cu")
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "probe.so"), src],
            capture_output=True, text=True, timeout=600,
        )
    print(proc.stdout + proc.stderr, flush=True)
    if proc.returncode != 0:
        return 1

    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    rows = []

    def device_ms(fn, name):
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        us = [e.self_device_time_total / e.count for e in prof.key_averages()
              if name in e.key]
        return us[0] / 1e3 if us else None

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for cell, capacity, unique in CELLS:
        pool = torch.randint(0, 1 << 62, (unique,), device=dev, generator=gen)
        pool = torch.unique(pool)
        batch = pool[torch.randint(0, pool.numel(), (BATCH_KEYS, 1),
                                   device=dev, generator=gen)]
        ht = ch.empty_hash(capacity, dev)
        ch.count_insert(ht, pool[:, None])  # every key once: steady state
        flat = ch.hash_to_table(ht)
        ch.count_insert(ht, batch)
        got = ch.hash_to_table(ht)
        want = count_torch.merge_raw_keys(flat, batch)
        torch.cuda.synchronize()
        cs.check(torch.equal(got.limbs, want.limbs)
                 and torch.equal(got.counts, want.counts)
                 and int(got.num_unique) == int(want.num_unique)
                 and not bool(got.overflow),
                 f"{cell}: the inserted table != merge_raw_keys")
        del got, want
        bound, nbytes = ch.insert_bound_ms(BATCH_KEYS)
        base = {"cell": cell, "capacity": capacity, "slots": ht.slots.shape[0],
                "unique": pool.numel(), "keys": BATCH_KEYS,
                "bound_ms": bound, "bytes": nbytes}

        steady = cs.time_cuda(torch, lambda: ch.count_insert(ht, batch),
                              args.reps)
        merge = cs.time_cuda(
            torch, lambda: count_torch.merge_raw_keys(flat, batch), args.reps)
        emit(dict(base, case="steady", ms=steady,
                  device_ms=device_ms(lambda: ch.count_insert(ht, batch),
                                      "count_insert_kernel"),
                  x_bound=steady / bound, merge_raw_keys_ms=merge))

        times = []
        for _ in range(args.reps):
            ht.slots[:, 0] = SENTINEL
            ht.slots[:, 1] = 0
            ht.claimed.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ch.count_insert(ht, batch)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        emit(dict(base, case="first", ms=sum(times) / len(times),
                  claimed=int(ht.claimed),
                  x_bound=sum(times) / len(times) / bound))

        finish = cs.time_cuda(torch, lambda: ch.hash_to_table(ht), args.reps)
        emit(dict(base, case="finish", ms=finish))
        del ht, flat, batch, pool
        torch.cuda.empty_cache()

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
            fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
