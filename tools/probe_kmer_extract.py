#!/usr/bin/env python3
"""Probe of the extraction kernel (``csrc/kmer_extract.cu``) on one GPU.

    PYTHONPATH=. python3 tools/probe_kmer_extract.py [--reps N] [--out FILE]

Prints the card's name and power limit, what ``ptxas -v`` says of the
kernel (registers, spills), checks the kernel against its plain version
at ``chip_smoke.TRAP_SHAPES``, and then times it with CUDA events:

  * at the main batch (262,144 reads x 100 bp, k=31, no invalid bits) with
    ``launch_plan``'s block and with blocks of other sizes, beside the
    bound (bytes over 3.35 TB/s) and a ``fill_`` of the same output (a
    plain write stream);
  * with its own plan at other k, with invalid bits, at 250 bp reads and
    at the sharded count's 65,536-read batch.

``ms`` is the mean of ``--reps`` calls of the wrapper's launch between two
CUDA events after two warm-ups, so it holds the host's enqueue time where
that is the longer; ``device_ms`` is the kernel's own mean time on the
card from ``torch.profiler`` over the same number of launches. The
146.8 MB output passes the 50 MB L2, so each launch finds it cold.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    import genome_assembler_tpu_torch.reference as ref
    from genome_assembler_tpu_torch.ops import _build, kmer_torch as kmer

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None,
                    help="also write the timed rows to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_kmer_extract: CUDA is not available", file=sys.stderr)
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

    cs.check_trap_shapes(torch, ref, kmer, dev)

    rng = np.random.default_rng(99)
    rows = []

    def timed(name, b, length, k, n_rate, reads_per_block=None):
        reads = cs.random_reads(rng, b, length, n_rate)
        packed, inv = cs.upload_reads(torch, ref, reads, dev)
        plan = kmer.launch_plan(length, k)
        if reads_per_block is not None:
            own = kmer.BLOCK_WINDOWS
            kmer.BLOCK_WINDOWS = reads_per_block * (length - k + 1)
            try:
                plan = kmer.launch_plan(length, k)
            finally:
                kmer.BLOCK_WINDOWS = own
            cs.check(plan.reads_per_block == reads_per_block,
                     f"asked for {reads_per_block} reads a block, got {plan}")
        got = kmer.launch_kernel(packed, length, k, None, inv, plan)
        want = kmer.extract_canonical_flat_ref(packed, length, k, None, inv)
        torch.cuda.synchronize()
        cs.check(torch.equal(got, want), f"{name}: kernel != plain version")
        fill = cs.time_cuda(torch, lambda: got.fill_(7), args.reps)
        del want
        ms = cs.time_cuda(
            torch,
            lambda: kmer.launch_kernel(packed, length, k, None, inv, plan),
            args.reps,
        )
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            for _ in range(args.reps):
                kmer.launch_kernel(packed, length, k, None, inv, plan)
            torch.cuda.synchronize()
        device_us = [e.self_device_time_total / e.count
                     for e in prof.key_averages()
                     if "extract_canonical_kernel" in e.key]
        bound, by, nbytes = cs.kernel_bound_ms(b, length, k, inv is not None)
        row = {"case": name, "reads": b, "read_len": length, "k": k,
               "invalid_bits": inv is not None, "plan": list(plan),
               "own_plan": plan == kmer.launch_plan(length, k), "ms": ms,
               "device_ms": device_us[0] / 1e3 if device_us else None,
               "bound_ms": bound, "bound_by": by, "bytes": nbytes,
               "x_bound": ms / bound, "fill_ms": fill}
        rows.append(row)
        print(json.dumps(row), flush=True)

    b, length, k = cs.MAIN_BATCH
    timed("main batch", b, length, k, 0.0)
    for reads_per_block in (8, 16, 32, 128, 256):
        timed(f"main batch, {reads_per_block} reads a block", b, length, k,
              0.0, reads_per_block)
    timed("main batch, Ns present", b, length, k, 0.01)
    for kk in (21, 25, 41, 63):
        timed(f"k={kk}", b, length, kk, 0.0)
    timed("k=41, Ns present", b, length, 41, 0.01)
    timed("250 bp reads, k=21", 104_858, 250, 21, 0.0)
    timed("a shard's batch", 65_536, length, k, 0.0)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
            fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
