#!/usr/bin/env python3
"""Probe of the streamed count's upload and 2-bit pack on one GPU.

    PYTHONPATH=. python3 tools/probe_upload.py [--reps N] [--out FILE]

Three ways to bring a batch of reads to the extraction kernel as packed
codes (``[B, ceil(L/4)]`` uint8, ambiguous bases apart as bits), measured
on CFG-2's reads (4,641,652 bp, 50x, 100 bp; 9 batches of 262,144 reads,
k=31, table capacity 5,242,880):

  host-sync    the host packs with ``utils.dna.pack_codes`` (fresh arrays
               a batch) and a pageable ``.to(device)`` moves the bytes:
               the loop the port had before the upload ring;
  host-pinned  the host packs straight into a pinned slot of an
               ``UploadRing`` (word-wise, no temporaries of the batch's
               size) and the copy stream moves the packed bytes;
  device       the raw one-byte codes go through the ring and plain torch
               ops pack them on the card: what the port keeps
               (``models.pipeline.pack_on_device``).

For one batch it prints the host's pack (or fill) time, the copy's time
and the device pack's time; for the whole count stage the wall seconds of
each variant in turns (``--reps`` rounds, each closed by a device
synchronise), the tables held equal, and from one profiled run each the
device's busy share of the stage. The two variants that the port does not
keep live only in this file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH, LENGTH, K = 262_144, 100, 31


def pack_codes_into(codes, out) -> None:
    """``utils.dna.pack_codes`` written into ``out``. Rows of a multiple
    of 4 bases are packed a 32-bit word at a time."""
    import numpy as np

    b, length = codes.shape
    if length % 4 == 0 and codes.flags.c_contiguous:
        t = codes.view("<u4") & np.uint32(0x03030303)
        t |= t >> np.uint32(6)
        t |= t >> np.uint32(12)
        np.copyto(out, t, casting="unsafe")  # keeps the low byte
        return
    from genome_assembler_tpu_torch.utils.dna import pack_codes

    out[:] = pack_codes(codes)


def pack_invalid_into(codes, out) -> None:
    """``utils.dna.pack_invalid_mask`` written into ``out`` (zeros for a
    batch without ambiguous bases)."""
    import numpy as np

    bad = codes > 3
    pad = (-codes.shape[1]) % 8
    if pad:
        bad = np.concatenate(
            [bad, np.zeros((codes.shape[0], pad), dtype=bool)], axis=1
        )
    out[:] = np.packbits(bad, axis=1, bitorder="little")


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    import genome_assembler_tpu_torch.reference as ref
    from genome_assembler_tpu_torch.models import pipeline
    from genome_assembler_tpu_torch.ops import _build
    from genome_assembler_tpu_torch.ops.stream_table import CarriedTable
    from genome_assembler_tpu_torch.ops.kmer_torch import (
        pack_codes_device,
        pack_invalid_device,
    )
    from genome_assembler_tpu_torch.utils import metrics as metrics_mod
    from genome_assembler_tpu_torch.utils.keys import snug_capacity
    from genome_assembler_tpu_torch.utils.upload import UploadRing

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="also write the measured rows to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_upload: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cs.card_info(torch)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    _build.kmer_extract_fn()

    glen = 4_641_652
    genome = ref.simulate_genome(glen, seed=1030)
    reads = ref.simulate_reads(genome, coverage=50, read_len=LENGTH,
                               seed=1031, tile_k=K).codes
    capacity = snug_capacity(int(1.1 * glen) + 4096)
    cfg = ref.AssemblyConfig(k=K, read_len=LENGTH)
    starts = range(0, reads.shape[0], BATCH)
    report: dict = {"reads": int(reads.shape[0]), "batches": len(starts)}

    # ---- one batch, piece by piece (host clock, device synchronised)
    rows = reads[:BATCH]
    cw, iw = (LENGTH + 3) // 4, (LENGTH + 7) // 8

    def clocked(fn, reps=7):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return median(times)

    pinned_packed = torch.empty((BATCH, cw), dtype=torch.uint8, pin_memory=True)
    pinned_raw = torch.empty((BATCH, LENGTH), dtype=torch.uint8,
                             pin_memory=True)
    dev_packed = torch.empty((BATCH, cw), dtype=torch.uint8, device=dev)
    dev_raw = torch.empty((BATCH, LENGTH), dtype=torch.uint8, device=dev)
    held = {}

    def host_pack():
        held["p"] = ref.pack_codes(rows)

    one = {
        "host-sync": {
            "pack_ms": clocked(host_pack),
            "copy_ms": clocked(
                lambda: torch.from_numpy(held["p"]).to(dev)),
            "bytes": BATCH * cw,
        },
        "host-pinned": {
            "pack_ms": clocked(
                lambda: pack_codes_into(rows, pinned_packed.numpy())),
            "copy_ms": clocked(
                lambda: dev_packed.copy_(pinned_packed, non_blocking=True)),
            "bytes": BATCH * cw,
        },
        "device": {
            "pack_ms": clocked(
                lambda: np.copyto(pinned_raw.numpy(), rows)),
            "copy_ms": clocked(
                lambda: dev_raw.copy_(pinned_raw, non_blocking=True)),
            "device_pack_ms": cs.time_cuda(
                torch, lambda: pack_codes_device(dev_raw), 20),
            "device_pack_invalid_ms": cs.time_cuda(
                torch, lambda: pack_invalid_device(dev_raw), 20),
            "bytes": BATCH * LENGTH,
        },
    }
    one["host-pinned"]["pack_invalid_ms"] = clocked(
        lambda: pack_invalid_into(rows, np.empty((BATCH, iw), np.uint8)))
    one["host-sync"]["pack_invalid_ms"] = clocked(
        lambda: ref.pack_invalid_mask(rows))
    check = np.empty((BATCH, cw), np.uint8)
    pack_codes_into(rows, check)
    cs.check(np.array_equal(check, ref.pack_codes(rows)),
             "pack_codes_into != pack_codes")
    cs.check(np.array_equal(pack_codes_device(dev_raw).cpu().numpy(), check),
             "pack_codes_device != pack_codes")
    for name, row in one.items():
        print(f"one batch {BATCH}x{LENGTH}, {name}: " + json.dumps(
            {k_: round(v, 4) if isinstance(v, float) else v
             for k_, v in row.items()}), flush=True)
    report["one_batch"] = one
    del pinned_packed, pinned_raw, dev_packed, dev_raw

    # ---- the whole count stage under each variant
    def stream(batches):
        table = CarriedTable(capacity, 1, dev, None)
        for packed, inv in batches:
            table.add(pipeline.extract_canonical_flat(packed, LENGTH, K,
                                                      inv_bits=inv))
        return table.finish()

    def count_host_sync():
        return stream(
            (torch.from_numpy(ref.pack_codes(reads[s : s + BATCH])).to(dev),
             None)
            for s in starts
        )

    def count_host_pinned():
        def fill(i, planes):
            r = reads[starts[i] : starts[i] + BATCH]
            pack_codes_into(r, planes[0][: r.shape[0]])
            return r.shape[0]

        with UploadRing([(dev, BATCH)], [cw], depth=2) as ring:
            return stream(
                (blocks[0][0], None)
                for _, blocks in ring.stream(0, len(starts), fill)
            )

    def count_device():
        return pipeline.count_reads_device(reads, cfg, device=dev,
                                           table_capacity=capacity)

    variants = {
        "host-sync": count_host_sync,
        "host-pinned": count_host_pinned,
        "device": count_device,
        "device, plain upload": lambda: pipeline.count_reads_device(
            reads, cfg, device=dev, table_capacity=capacity,
            _plain_upload=True),
    }
    tables = {}
    for name, fn in variants.items():  # warm-up, and the tables
        tables[name] = fn()
        torch.cuda.synchronize()
    want = tables["host-sync"]
    for name, t in tables.items():
        cs.check(cs.tables_equal(torch, t, want),
                 f"{name}: table != host-sync table")
    print(f"tables of all {len(variants)} variants equal "
          f"({int(want.num_unique)} unique k-mers)", flush=True)
    del tables, want
    secs = {name: [] for name in variants}
    order = list(variants)
    for rep in range(args.reps):
        for name in order if rep % 2 == 0 else reversed(order):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            variants[name]()
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
    report["count_s"] = secs
    for name, xs in secs.items():
        print(f"CFG-2 count, {name}: " +
              " / ".join(f"{x:.4f}" for x in xs) + " s", flush=True)

    # ---- device busy share of the stage, one profiled run each
    busy = {}
    for name, fn in variants.items():
        with tempfile.TemporaryDirectory() as tmp:
            m = pipeline.Metrics()
            with metrics_mod.profiler_trace(tmp):
                with pipeline.timed_stage(m, "count", dev):
                    fn()
            trace = metrics_mod.read_trace(tmp)
        b_s, w_s = trace.busy_share("count")
        busy[name] = {"busy_s": b_s, "wall_s": w_s,
                      "idle_share": 1 - b_s / w_s}
        print(f"CFG-2 count profiled, {name}: device busy {b_s:.4f} s of "
              f"{w_s:.4f} s, idle {100 * (1 - b_s / w_s):.1f}%", flush=True)
    report["profiled"] = busy
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
