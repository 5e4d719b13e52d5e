#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``genome_assembler_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

  1. the card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
     power limit;
  2. build ``genome_assembler_tpu_torch/csrc/kmer_extract.cu``: the
     extraction and the pack kernel, one library;
  3. the kernel against its plain torch version on the card, bit-equal:
     k in {21, 25, 31, 41, 63} with ambiguous bases and n_valid < B, the
     edge shapes of its block layout (one window a read, read lengths off
     a multiple of 4 and 8, one read, ragged last blocks, n_valid 0 and
     inside a block, reads of only Ns, k in {2, 31, 32, 63}, a shape that
     opts in to more shared memory, a shape it must refuse), and the main
     path's batch shape (262,144 reads x 100 bp, k=31); then both timed at
     that shape with CUDA events, beside the least time the card could
     take for the same bytes;
  4. contigs against the NumPy oracle, bit-equal: CFG-0 (10 kb, 100x,
     k=25), CFG-1 (48.5 kb, 1% errors, k=31, min_count 5) and a two-limb
     case (150 kb, 50x, k=41);
  5. CFG-2 at full size (4,641,652 bp, 50x, 100 bp reads, k=31, table
     capacity 5,242,880): one cold run, then a warm run with the kernel's
     launch counter reset just before it; the contig must equal the
     genome, and the warm per-stage seconds are printed;
  6. the sharded count on a mesh of 4 shards over the visible GPUs:
     CFG-1's contigs from ``assemble_distributed`` equal the oracle's,
     with per-window and with minimizer (m=15) routing, and the routed
     bytes of both are printed; CFG-1 through the sharded graph
     (``assemble_distributed_sharded``) gives the same contigs;
  7. CFG-4 at full size (12,000,000 bp, 100x, 100 bp reads, k=31, table
     capacity snug_capacity(1.5 x genome + 4096)) on 4 shards, streamed:
     the kernel against its plain version, bit-equal, on the inputs its
     run hands each shard in the first and the tail batch (the shapes and
     n_valid of the run's stream plan);
     ``assemble_distributed`` with the launch counter reset just before
     it gives one contig equal to the genome (wall and stage seconds,
     routed bytes and peak device memory printed); the gathered table
     equals the single-device ``count_reads_device`` table bit for bit;
     one streamed batch is timed with CUDA events with and without its
     merge, for the routing step's share;
  8. CFG-4 through the sharded graph on 4 shards
     (``assemble_distributed_sharded`` with a ``"hash_shards"``
     checkpoint), the launch counter reset just before it: one contig
     equal to the genome and to the gathered path's; stage seconds, query
     rounds, routed bytes and peak memory per card printed; then resumed
     from the checkpoint with zeroed reads to the same contig;
  9. a mid-stream stop and resume on the card (CFG-2 reads, one device
     and 4 shards): the resumed table equals the uninterrupted one;
 10. the upload pipeline at full size: CFG-2's 9 batches through the
     pinned ring (launch counter reset just before) give the table of the
     same reads uploaded batch by batch with a plain ``.to(device)``
     (``count_reads_device(_plain_upload=True)``), bit for bit; the same
     with Ns in the reads and a batch size that leaves a short last
     batch; the ``count`` stage's seconds and the device's idle share over
     it from a ``torch.profiler`` trace, and one batch's fill, copy and
     device milliseconds. (CFG-4's sharded count is read the same way
     inside phase 7, from the run that gathers its table.);
 11. the acceptance runners 0, 1, 2 and 5 at full size through
     ``models.acceptance.run`` on the card: each must pass, each JSON line
     is printed;
 12. the command line, as subprocesses at CFG-1's size: ``ga-torch
     simulate`` -> file -> ``ga-torch assemble --gfa --stats --metrics-out
     --trace-dir`` -> ``ga-torch stats``; exit codes, the trace's CUDA
     kernels and stage names, and ``derived.hbm_roofline_frac`` < 1;
 13. the multi-process mesh: CFG-4 at full size (its 12,000,000 reads
     written once to a lines file that every rank loads) through
     ``ga-torch assemble --backend dist --devices 4 --hosts n`` started by
     ``parallel/launch.py::spawn`` as ``n = min(4, visible cards)`` ranks,
     NCCL, a card a rank, with ``--sharded-graph`` and a ``"hash_shards"``
     checkpoint and then gathered. Every rank must exit 0 inside the time
     limit and write the same contigs file; the contig must equal the
     genome and phase 8's; the checkpoint the ranks wrote must equal
     phase 8's array for array; ``hosts`` in every rank's metrics must be
     ``n``; the ranks' kernel launches (from their metrics files) are
     summed. Ranks, cards, rank 0's wall and stage seconds, query rounds,
     seconds a doubling round and peak GiB a card are printed beside
     phases 7-8's single-process numbers. Where only one card is visible
     NCCL cannot hold two ranks on it: the phase then runs one rank with
     four local shards through the same ``torch.distributed`` calls and
     prints ``"ranks": 1, "cross_process": false``;
 14. the ranking: on CFG-2's full-size filtered table (9.4M edge rows)
     ``compress_unitigs_device`` takes the sampled two-level pass, and its
     outputs equal the forced exact pass's bit for bit; both are timed
     warm with CUDA events over three calls, whole and the ranking alone,
     with the rounds of phase A, phase B and the exact pass. On CFG-5's
     circular table (4,641,652 bp, 50x) the sampled pass must refuse, and
     the cyclic pass must accept and equal the exact pass. CFG-4 through
     the sharded graph on 4 shards (phase 7's reads, counted and filtered
     as ``assemble_distributed_sharded`` does), sampled against forced
     exact: per-shard outputs equal, query rounds below the exact pass's
     26 at this size, query rounds, doubling seconds and ``compress``
     seconds of each; where more than one card is visible the same
     again as ``min(4, cards)`` NCCL ranks (this script with
     ``--rank-compress``, started by ``parallel/launch.py::spawn``);
 15. the bucketed merge: CFG-4's 12,000,000 reads on one device through
     ``count_reads_device`` with ``bucketed="off"`` and ``"on"`` (``"auto"``
     must pick ``"on"`` at this size), the tables bit-equal, ``count``
     seconds of each and the geometry printed; a bucketed stop and resume
     on CFG-2's reads equals the uninterrupted run; CFG-4 on 4 shards with
     ``bucketed="on"`` against ``"off"``: per-shard tables equal;
 16. deferred merges (``merge_stride``): CFG-4's reads on one device at
     strides 1, 2, 4 and 8 with ``bucketed="off"`` (twice, the second
     time in the reverse order) and ``"auto"`` (once); every table
     bit-equal to the flat stride-1 one; ``count`` seconds, the layout
     ``auto`` takes, the rows a merge sorts and the peak GiB printed; on
     4 shards at strides 2 and 4, ``"auto"`` and ``"off"``, shard tables
     equal to stride 1's; a stride-3 stop and resume on CFG-2's reads,
     one device and 4 shards, and the 4-shard snapshot resharded to 2
     shards and resumed.
 17. the entry points beyond the library, each a subprocess on the card
     after this process frees its cached memory: ``bench_torch.py`` at its
     defaults (1 Mb, 25x, k=31: 250,000 reads, 17.5M windows) must give
     ``exact_match``, a value above 0, ``min_traffic_roofline_frac`` below
     1, the kernel equal to its plain version at the bench's shape and
     within ten times its bound, and the streamed table equal to the single
     shot; ``tools/run_large_torch.py 40 25 31 --reps 1`` (40 Mb, 25x:
     10,000,000 reads, 700M windows, a table of 50,331,648 rows) must give
     one contig of 40,000,000 bases equal to the genome,
     ``exact_kmer_content``, and two launches a batch (cold and warm). Both
     JSON lines and the phase's seconds are printed.
 18. (run right after phase 3, before any phase that starts
     torch.profiler, after which a call's CUDA-event time reads slower)
     the pack kernel (``pack_reads_kernel`` in ``csrc/kmer_extract.cu``)
     against its plain version, byte for byte, and its flag: at L in
     {99, 100, 101, 250} with no N, Ns, a ragged batch of 333 reads and
     an N in the last base of the last row only, and at the main path's
     262,144, 250,000 and 70,826 reads of 100 bases with no N, Ns and an N
     in the last base only; the extraction kernel with the pack's flag
     equal to it without invalid bits (flag 0) and to the plain version
     (flag set), and the masked windows it counts on the card equal to
     the host's, at k in {21, 31, 41} and at the main batch. Both timed at
     the main batch as graphs of launches on inputs that do not fit L2
     (the pack clean and with Ns, beside its bound, a wrapper call and the
     plain pack; extraction without bits, with the flag at 0 and set),
     each time held to its bound: one under it fails the run. Every
     main path checks its pack launches (one a batch on one device).

The line before the last is the kernel report (launches summed over the
main-path runs: CFG-2, CFG-4 gathered, CFG-4 sharded graph, the upload
phase's ring run, the acceptance runners, the multi-process ranks, the
bucketed counts of phase 15, the strided counts of phase 16, and
phase 17's bench (its count, streamed and assembly legs; not the launches
that check and time the kernel) and 40 Mb run, and given for each in
``launches_by_path``), then the pack kernel's (its launches on the same
paths, its times from phase 18); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Neither JAX nor the JAX package is ever imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

KERNEL_SOURCE = "genome_assembler_tpu_torch/csrc/kmer_extract.cu"
KERNEL_REPLACES = "genome_assembler_tpu/ops/kmer_pallas.py:35"
MAIN_BATCH = (262_144, 100, 31)  # reads, read length, k of one CFG-2 batch

# Edge shapes of the kernel's block layout: (reads, read length, k,
# n_valid, share of Ns). Reads 1 and 2 of each case (where there are
# three) are all Ns, and an N in the first and in the last base.
TRAP_SHAPES = [
    (5, 31, 31, 5, 0.0),        # one window a read
    (4, 63, 63, 3, 0.01),       # one two-limb window a read
    (7, 2, 2, 7, 0.1),          # k = 2, L = k
    (3, 100, 2, 3, 0.02),
    (1, 100, 31, 1, 0.0),       # one read: half a block's pair
    (1, 101, 31, 1, 0.02),      # one read, odd window count: odd span
    (65, 101, 31, 65, 0.01),    # ragged last block of one read, odd span
    (130, 100, 31, 70, 0.01),   # n_valid inside a block
    (257, 103, 31, 0, 0.01),    # n_valid = 0
    (33, 99, 32, 20, 0.02),     # k = 32: the complement enters the low limb
    (33, 97, 63, 33, 0.02),
    (37, 250, 21, 36, 0.01),    # long reads: fewer reads a block
    (3, 4000, 31, 3, 0.001),    # two reads a block
    (3, 140_000, 31, 3, 0.0001),  # two reads' rows pass 48 KB: opt-in
    (6, 50, 25, 6, 0.5),        # mostly Ns
]
REFUSED_SHAPE = (2, 400_000, 31)  # two reads' rows pass a block's 227 KB


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info(torch) -> str:
    from genome_assembler_tpu_torch.utils.device import card_line

    name = torch.cuda.get_device_name(0)
    log(f"device: {name}")
    log(card_line(torch.device("cuda", 0)))
    return name


def random_reads(rng, b, length, n_rate):
    import numpy as np

    reads = rng.integers(0, 4, size=(b, length), dtype=np.uint8)
    if n_rate:
        reads[rng.random(reads.shape) < n_rate] = 4
    return reads


def upload_reads(torch, ref, reads, dev):
    packed = torch.from_numpy(ref.pack_codes(reads)).to(dev)
    inv = ref.pack_invalid_mask(reads)
    return packed, None if inv is None else torch.from_numpy(inv).to(dev)


def max_abs_err(torch, got, want) -> int:
    """Exact max |got - want| over int64 limbs (0 iff bit-equal)."""
    diff = got != want
    if not bool(diff.any()):
        return 0
    g = got[diff][:4096].cpu().tolist()
    w = want[diff][:4096].cpu().tolist()
    return max(abs(a - b) for a, b in zip(g, w))


def time_cuda(torch, fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# the pack kernel's launches by path, beside the extraction kernel's
PACK_LAUNCHES: dict[str, int] = {}


def reset_launches(kmer) -> None:
    """Zero the extraction and the pack kernel's launch counters."""
    kmer.extract_canonical_flat.launches = kmer.pack_on_device.launches = 0


def tally_packs(kmer, path: str) -> int:
    """Add the pack kernel's launches since the last reset to ``path``."""
    PACK_LAUNCHES[path] = (PACK_LAUNCHES.get(path, 0)
                           + kmer.pack_on_device.launches)
    return kmer.pack_on_device.launches


def graph_ms(torch, calls, reps: int) -> float:
    """Device ms of one call: ``reps`` calls cycling through ``calls``
    (each on inputs of its own, more bytes together than the card's 50 MB
    L2, so no call reads what the one before left there), captured in one
    CUDA graph and replayed between two CUDA events, so that the host's
    time to launch is not counted; every output lives until the replay
    ends, so no call writes over lines an earlier one left in L2. The
    median of five replays."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [calls[i % len(calls)]() for i in range(reps)]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(5):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del outs, graph
    torch.cuda.empty_cache()
    return sorted(times)[2]


def check_trap_shapes(torch, ref, kmer, dev) -> int:
    """The kernel, bit-equal to its plain version at TRAP_SHAPES with and
    without invalid bits, and REFUSED_SHAPE raising; returns the count."""
    import numpy as np

    rng = np.random.default_rng(4242)
    for b, length, k, n_valid, n_rate in TRAP_SHAPES:
        reads = random_reads(rng, b, length, n_rate)
        if b >= 3:
            reads[1, :] = 4
            reads[2, 0] = reads[2, -1] = 4
        packed, inv = upload_reads(torch, ref, reads, dev)
        # whole, and from read 1 on: a view whose rows start off a word
        for first in (0, 1) if b >= 3 else (0,):
            rows, nv = packed[first:], max(0, n_valid - first)
            for bits in (None if inv is None else inv[first:], None):
                got = kmer.extract_canonical_flat(rows, length, k, nv, bits)
                want = kmer.extract_canonical_flat_ref(rows, length, k, nv,
                                                       bits)
                torch.cuda.synchronize()
                err = max_abs_err(torch, got, want)
                check(err == 0, f"kernel != plain version at B={b - first}, "
                      f"L={length}, k={k}, n_valid={nv}, invalid bits "
                      f"{'absent' if bits is None else 'present'}, from read "
                      f"{first} (max err {err})")
    b, length, k = REFUSED_SHAPE
    packed = torch.zeros((b, (length + 3) // 4), dtype=torch.uint8, device=dev)
    before = kmer.extract_canonical_flat.launches
    try:
        kmer.extract_canonical_flat(packed, length, k)
    except ValueError as e:
        check("shared memory" in str(e), f"unexpected refusal: {e}")
    else:
        check(False, f"the kernel took L={length}, k={k}, which it must refuse")
    check(kmer.extract_canonical_flat.launches == before,
          "a refused shape was counted as a launch")
    log(f"kernel edge shapes: bit-equal to the plain version at "
        f"{len(TRAP_SHAPES)} shapes, with and without invalid bits; "
        f"L={length}, k={k} refused with a ValueError")
    return len(TRAP_SHAPES)


def phase_kernel(torch, ref, kmer, dev):
    import numpy as np

    rng = np.random.default_rng(2024)
    worst = 0
    for k in (21, 25, 31, 41, 63):
        reads = random_reads(rng, 1000, 100, 0.01)
        packed, inv = upload_reads(torch, ref, reads, dev)
        got = kmer.extract_canonical_flat(packed, 100, k, 777, inv)
        want = kmer.extract_canonical_flat_ref(packed, 100, k, 777, inv)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        check(err == 0, f"kernel != plain version at k={k} (max err {err})")
        check(bool((got[777 * (100 - k + 1):] == kmer.SENTINEL).all()),
              f"rows >= n_valid not masked at k={k}")
        worst = max(worst, err)
        log(f"kernel k={k}: bit-equal to the plain version "
            f"(B=1000, n_valid=777, Ns present)")
    check_trap_shapes(torch, ref, kmer, dev)
    b, length, k = MAIN_BATCH
    reads = random_reads(rng, b, length, 0.0)
    packed, inv = upload_reads(torch, ref, reads, dev)
    check(inv is None, "the timed main batch carries no invalid bits")
    got = kmer.extract_canonical_flat(packed, length, k)
    want = kmer.extract_canonical_flat_ref(packed, length, k)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    check(err == 0, f"kernel != plain version at the main batch (err {err})")
    worst = max(worst, err)
    del got, want
    ms = time_cuda(
        torch, lambda: kmer.extract_canonical_flat(packed, length, k), 20
    )
    plain_ms = time_cuda(
        torch, lambda: kmer.extract_canonical_flat_ref(packed, length, k), 5
    )
    bound_ms, bound_by, nbytes = kmer.kernel_bound_ms(b, length, k, False)
    windows = b * (length - k + 1)
    log(f"kernel main batch {b}x{length} k={k}: bit-equal; kernel "
        f"{ms:.4f} ms ({windows / ms / 1e6:.1f} G windows/s, "
        f"{nbytes / ms / 1e9:.3f} TB/s), bound {bound_ms:.4f} ms ({nbytes} "
        f"bytes at {kmer.HBM_PEAK_BYTES_S / 1e12} TB/s; "
        f"{ms / bound_ms:.2f}x), "
        f"plain torch {plain_ms:.4f} ms")
    return worst, {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by}


PACK_LENGTHS = (99, 100, 101, 250)
# the main path's batches: CFG-2's, and the upload phase's batches of
# 250,000 reads with their 70,826-read tail
PACK_MAIN_ROWS = (MAIN_BATCH[0], 250_000, 70_826)


def check_pack(torch, kmer, reads, dev, what: str) -> None:
    """The pack kernel on ``reads`` against its plain version (on the CPU),
    byte for byte, and its flag against the reads."""
    codes = torch.from_numpy(reads).to(dev)
    got = kmer.pack_on_device(codes)
    want = kmer.pack_on_device(codes.cpu())
    torch.cuda.synchronize()
    for name in ("packed", "inv"):
        check(torch.equal(getattr(got, name).cpu(), getattr(want, name)),
              f"pack kernel {name} != plain version at {what}")
    check(bool(got.flag) == bool((reads > 3).any()),
          f"pack kernel flag {int(got.flag)} at {what}")


def phase_pack(torch, ref, kmer, dev):
    """The pack kernel (csrc/kmer_extract.cu's pack_reads_kernel) against
    its plain version, byte for byte, with its flag, at edge shapes and at
    the main path's; the extraction kernel reading the flag against its
    plain version at the main batch; both timed there, each time held to
    its bound."""
    import numpy as np

    from genome_assembler_tpu_torch.ops.kmer_ref import window_valid_np

    rng = np.random.default_rng(15)
    cases = 0
    for length in PACK_LENGTHS:
        for b, n_rate, last in ((1024, 0.0, False), (1024, 0.01, False),
                                (333, 0.01, False), (1024, 0.0, True)):
            reads = random_reads(rng, b, length, n_rate)
            if last:
                reads[-1, -1] = 4
            check_pack(torch, kmer, reads, dev, f"B={b}, L={length}, N "
                       f"share {n_rate}, N last {last}")
            cases += 1
    for b in PACK_MAIN_ROWS:
        for n_rate, last in ((0.0, False), (0.001, False), (0.0, True)):
            reads = random_reads(rng, b, 100, n_rate)
            if last:
                reads[-1, -1] = 4
            check_pack(torch, kmer, reads, dev, f"B={b}, L=100, N share "
                       f"{n_rate}, N last {last}")
            cases += 1
    for k in (21, 31, 41):
        for n_rate in (0.0, 0.01):
            reads = random_reads(rng, 1000, 100, n_rate)
            p = kmer.pack_on_device(torch.from_numpy(reads).to(dev))
            masked = torch.zeros((), dtype=torch.int64, device=dev)
            got = kmer.extract_canonical_flat(p.packed, 100, k, 777, p.inv,
                                              flag=p.flag, masked=masked)
            want = kmer.extract_canonical_flat(
                p.packed, 100, k, 777, p.inv if n_rate else None)
            plain = kmer.extract_canonical_flat_ref(p.packed, 100, k, 777,
                                                    p.inv)
            torch.cuda.synchronize()
            check(torch.equal(got, want) and torch.equal(got, plain),
                  f"extraction with the flag != without it at k={k}, "
                  f"N share {n_rate}")
            n = int((~window_valid_np(reads[:777], k)).sum())
            check(int(masked) == n, f"the card counted {int(masked)} masked "
                  f"windows at k={k}, the host {n}")

    # the main batch: clean and with Ns, each in four copies for the timing
    b, length, k = MAIN_BATCH
    clean = [torch.from_numpy(random_reads(rng, b, length, 0.0)).to(dev)
             for _ in range(4)]
    noisy_host = random_reads(rng, b, length, 0.001)
    noisy = [torch.from_numpy(noisy_host).to(dev)] + [
        torch.from_numpy(random_reads(rng, b, length, 0.001)).to(dev)
        for _ in range(3)]
    p = [kmer.pack_on_device(c) for c in clean]
    pn = [kmer.pack_on_device(c) for c in noisy]
    masked = torch.zeros((), dtype=torch.int64, device=dev)
    flag_0 = kmer.extract_canonical_flat(p[0].packed, length, k,
                                         inv_bits=p[0].inv, flag=p[0].flag)
    no_bits = kmer.extract_canonical_flat(p[0].packed, length, k)
    flag_0_equal = torch.equal(flag_0, no_bits)
    del flag_0, no_bits
    flag_set = kmer.extract_canonical_flat(pn[0].packed, length, k,
                                           inv_bits=pn[0].inv,
                                           flag=pn[0].flag, masked=masked)
    plain = kmer.extract_canonical_flat_ref(pn[0].packed, length, k,
                                            inv_bits=pn[0].inv)
    flag_set_equal = torch.equal(flag_set, plain)
    del flag_set, plain
    n = int((~window_valid_np(noisy_host, k)).sum())
    check(flag_0_equal, f"extraction at {b}x{length} with the flag at 0 != "
          f"without bits")
    check(flag_set_equal, f"extraction at {b}x{length} with the flag set != "
          f"the plain version")
    check(int(masked) == n > 0, f"the card counted {int(masked)} masked "
          f"windows at {b}x{length}, the host {n}")
    log(f"pack kernel: bytes and flag equal to the plain version in {cases} "
        f"cases (L in {PACK_LENGTHS}: no N, Ns, a ragged batch, an N in the "
        f"last base only; {PACK_MAIN_ROWS} reads of 100 bases: no N, Ns, an "
        f"N in the last base only); extraction with the flag equal to it "
        f"without bits (flag 0) and to the plain version (flag set) at k in "
        f"(21, 31, 41) and at {b}x{length}, masked windows counted on the "
        f"card equal to the host's ({n} at {b}x{length})")

    # the wrapper's calls are host bound (CUDA events give about 40 us a
    # call): the kernels' own times come from graphs of launches
    call_ms = time_cuda(torch, lambda: kmer.pack_on_device(clean[0]), 50)
    plain_ms = time_cuda(torch, lambda: (kmer.pack_codes_device(clean[0]),
                                         kmer.pack_invalid_device(clean[0]),
                                         (clean[0] > 3).any()), 20)
    ms = graph_ms(torch, [lambda c=c: kmer.pack_on_device(c)
                          for c in clean], 64)
    ms_n = graph_ms(torch, [lambda c=c: kmer.pack_on_device(c)
                            for c in noisy], 64)
    nbytes = b * (length + (length + 3) // 4 + (length + 7) // 8)
    bound_ms = nbytes / kmer.HBM_PEAK_BYTES_S * 1e3
    extract = {
        "no_bits": [lambda q=q: kmer.extract_canonical_flat(
            q.packed, length, k) for q in p],
        "flag_0": [lambda q=q: kmer.extract_canonical_flat(
            q.packed, length, k, inv_bits=q.inv, flag=q.flag) for q in p],
        "flag_set": [lambda q=q: kmer.extract_canonical_flat(
            q.packed, length, k, inv_bits=q.inv, flag=q.flag, masked=masked)
            for q in pn],
    }
    extract_ms = {name: graph_ms(torch, fns, 16)
                  for name, fns in extract.items()}
    extract_bound = {name: kmer.kernel_bound_ms(b, length, k,
                                                name == "flag_set")[0]
                     for name in extract}
    log(f"pack kernel main batch {b}x{length}: device {ms * 1e3:.2f} us "
        f"clean, {ms_n * 1e3:.2f} us with Ns (a wrapper call "
        f"{call_ms * 1e3:.2f} us), bound {bound_ms * 1e3:.2f} us "
        f"({nbytes} bytes at {kmer.HBM_PEAK_BYTES_S / 1e12} TB/s; "
        f"{ms / bound_ms:.2f}x), plain torch {plain_ms:.4f} ms; "
        f"extraction, device ms: " + json.dumps(
            {n_: round(v, 4) for n_, v in extract_ms.items()})
        + ", bounds: " + json.dumps(
            {n_: round(v, 4) for n_, v in extract_bound.items()}))
    for name, got_ms, want_ms in (
            ("pack, clean", ms, bound_ms), ("pack, Ns", ms_n, bound_ms),
            *((f"extraction, {n_}", extract_ms[n_], extract_bound[n_])
              for n_ in extract)):
        check(got_ms >= want_ms, f"{name}: {got_ms:.4f} ms on the device, "
              f"under its {want_ms:.4f} ms bound: the timing is wrong")
    return {"ms": ms, "ms_with_ns": ms_n, "call_ms": call_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "extract_ms": extract_ms, "extract_bound_ms": extract_bound}


def cfg1_reads(ref):
    genome = ref.simulate_genome(48_502, seed=1020)
    rs = ref.simulate_reads(genome, coverage=100, read_len=100, seed=1021,
                            error_rate=0.01, tile_k=31)
    return rs.codes, ref.AssemblyConfig(k=31, min_count=5, read_len=100)


def phase_oracle(torch, ref, pipeline, dev):
    cases = [
        ("CFG-0", 10_000, 100, 25, 0.0, 1, 1010),
        ("CFG-1", 48_502, 100, 31, 0.01, 5, 1020),
        ("two-limb k=41", 150_000, 50, 41, 0.0, 1, 1040),
    ]
    for name, glen, cov, k, err, mc, seed in cases:
        genome = ref.simulate_genome(glen, seed=seed)
        rs = ref.simulate_reads(genome, coverage=cov, read_len=100,
                                seed=seed + 1, error_rate=err, tile_k=k)
        cfg = ref.AssemblyConfig(k=k, min_count=mc, read_len=100)
        t0 = time.perf_counter()
        got = pipeline.assemble_torch(rs.codes, cfg, device=dev)
        t_port = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = ref.assemble_oracle(rs.codes, cfg)
        t_oracle = time.perf_counter() - t0
        check(got == want, f"{name}: port contigs != oracle contigs "
              f"({len(got)} vs {len(want)})")
        log(f"{name}: {len(got)} contig(s) equal to the oracle "
            f"(port {t_port:.2f} s incl. first-call setup, oracle "
            f"{t_oracle:.2f} s on the host)")


def phase_cfg2(torch, ref, pipeline, kmer, dev):
    from genome_assembler_tpu_torch.utils.keys import snug_capacity

    glen, seed, k = 4_641_652, 1030, 31
    t0 = time.perf_counter()
    genome = ref.simulate_genome(glen, seed=seed)
    rs = ref.simulate_reads(genome, coverage=50, read_len=100, seed=seed + 1,
                            tile_k=k)
    log(f"CFG-2: simulated {rs.num_reads} reads in "
        f"{time.perf_counter() - t0:.2f} s")
    capacity = snug_capacity(int(1.1 * glen) + 4096)
    check(capacity == 5_242_880, f"unexpected CFG-2 capacity {capacity}")
    cfg = ref.AssemblyConfig(k=k, read_len=100)
    want = [ref.decode_seq(genome)]

    t0 = time.perf_counter()
    cold = pipeline.assemble_torch(rs.codes, cfg, device=dev,
                                   table_capacity=capacity)
    log(f"CFG-2 cold run: {time.perf_counter() - t0:.2f} s")
    check(ref.contigs_equal(cold, want), "CFG-2 cold run != genome")

    m = pipeline.Metrics()
    reset_launches(kmer)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    contigs = pipeline.assemble_torch(rs.codes, cfg, device=dev,
                                      table_capacity=capacity, metrics=m)
    wall = time.perf_counter() - t0
    launches = kmer.extract_canonical_flat.launches
    check(tally_packs(kmer, "cfg2") == launches,
          f"CFG-2 main path packed {kmer.pack_on_device.launches} batches "
          f"on the card for {launches} extractions")
    check(m.counters["ambiguous_batches"] == 0
          and "masked_windows" not in m.counters,
          f"CFG-2 has no N, yet the card counted {m.counters}")
    peak = torch.cuda.max_memory_allocated(dev)
    check(len(contigs) == 1, f"CFG-2: {len(contigs)} contigs, expected 1")
    check(ref.contigs_equal(contigs, want), "CFG-2 contig != genome")
    check(launches == -(-rs.num_reads // cfg.batch_reads),
          f"CFG-2 main path launched the kernel {launches} times, not once "
          f"a streamed batch")
    windows = rs.num_reads * (100 - k + 1)
    stages = {name: round(s, 4) for name, s in m.stages.items()}
    log(f"CFG-2 warm run: {wall:.3f} s wall, 1 contig == genome "
        f"({len(contigs[0])} bp), {windows} windows, kernel launches "
        f"{launches}, peak device memory {peak / 2**30:.2f} GiB")
    log("CFG-2 warm stages (s): " + json.dumps(stages))
    return launches, rs.codes, capacity


def tables_equal(torch, a, b) -> bool:
    """Bit-equal tables up to num_unique (capacities may differ)."""
    n = int(a.num_unique)
    return (
        n == int(b.num_unique)
        and not bool(a.overflow) and not bool(b.overflow)
        and torch.equal(a.limbs[:n], b.limbs[:n])
        and torch.equal(a.counts[:n], b.counts[:n])
    )


def phase_mesh_cfg1(torch, ref, dist, mesh_mod):
    reads, cfg = cfg1_reads(ref)
    want = ref.assemble_oracle(reads, cfg)
    mesh = mesh_mod.build_mesh(4)
    log(f"mesh: {mesh}")
    wire = {}
    for mini in (None, 15):
        m = dist.Metrics()
        got = dist.assemble_distributed(reads, cfg, mesh, metrics=m,
                                        minimizer_len=mini)
        name = "per-window" if mini is None else f"minimizer m={mini}"
        check(got == want, f"CFG-1 on 4 shards ({name}) != oracle "
              f"({len(got)} vs {len(want)} contigs)")
        wire[name] = int(m.counters["a2a_bytes_count"])
        log(f"CFG-1 on 4 shards, {name}: {len(got)} contig(s) equal to the "
            f"oracle; routed {wire[name]} bytes")
    log(f"CFG-1 routed bytes, per-window / minimizer: "
        f"{wire['per-window'] / wire['minimizer m=15']:.2f}x")
    m = dist.Metrics()
    got = dist.assemble_distributed_sharded(reads, cfg, mesh, metrics=m)
    check(got == want, f"CFG-1 on 4 shards through the sharded graph != "
          f"assemble_distributed ({len(got)} vs {len(want)} contigs)")
    log(f"CFG-1 on 4 shards, sharded graph: {len(got)} contig(s) equal to "
        f"assemble_distributed's and the oracle's; "
        f"{int(m.counters['a2a_compress_query_rounds'])} query rounds")


def reset_peaks(torch, mesh) -> None:
    for dev in dict.fromkeys(mesh.devices):
        torch.zeros(1, device=dev)  # a card's allocator starts at first use
        torch.cuda.reset_peak_memory_stats(dev)


def peaks_gib(torch, mesh) -> list[float]:
    """Peak allocated GiB of each card the mesh uses."""
    return [round(torch.cuda.max_memory_allocated(dev) / 2**30, 2)
            for dev in dict.fromkeys(mesh.devices)]


def phase_cfg4(torch, ref, pipeline, dist, mesh_mod, metrics_mod, kmer, dev):
    from genome_assembler_tpu_torch.ops import count_torch
    from genome_assembler_tpu_torch.utils.keys import snug_capacity

    glen, k = 12_000_000, 31
    t0 = time.perf_counter()
    genome = ref.simulate_genome(glen, seed=1050)
    rs = ref.simulate_reads(genome, coverage=100, read_len=100, seed=1051)
    log(f"CFG-4: simulated {rs.num_reads} reads in "
        f"{time.perf_counter() - t0:.2f} s")
    capacity = snug_capacity(int(1.5 * glen) + 4096)
    cfg = ref.AssemblyConfig(k=k, read_len=100)
    mesh = mesh_mod.build_mesh(4)
    want = [ref.decode_seq(genome)]
    windows = rs.num_reads * (100 - k + 1)
    plan = dist._StreamPlan(rs.num_reads, 100, cfg, mesh.size, None, None,
                            capacity)
    err = 0
    for i in sorted({0, plan.num_batches - 1}):
        # the kernel's inputs in this run: the first and the tail batch,
        # every shard with its n_valid
        packed, _, n_valid = dist._stream_batch(mesh, rs.codes, plan, i, False)
        for s, nv in enumerate(n_valid):
            got = kmer.extract_canonical_flat(packed[s], 100, k, nv)
            ref_keys = kmer.extract_canonical_flat_ref(packed[s], 100, k, nv)
            torch.cuda.synchronize()
            e = max_abs_err(torch, got, ref_keys)
            check(e == 0, f"CFG-4 batch {i} shard {s}: kernel != plain "
                  f"version at {packed[s].shape[0]} reads, n_valid {nv} "
                  f"(max err {e})")
            err = max(err, e)
        log(f"CFG-4 kernel inputs of batch {i}/{plan.num_batches}: bit-equal "
            f"to the plain version on every shard ({plan.per_dev} reads x "
            f"100 a shard, n_valid {n_valid})")
    del packed, got, ref_keys

    m = dist.Metrics()
    reset_launches(kmer)
    reset_peaks(torch, mesh)
    t0 = time.perf_counter()
    contigs = dist.assemble_distributed(rs.codes, cfg, mesh, metrics=m,
                                        table_capacity=capacity)
    wall = time.perf_counter() - t0
    launches = kmer.extract_canonical_flat.launches
    check(tally_packs(kmer, "cfg4_gathered") > 0,
          "CFG-4 main path never launched the pack kernel")
    peak = peaks_gib(torch, mesh)
    check(len(contigs) == 1, f"CFG-4: {len(contigs)} contigs, expected 1")
    check(ref.contigs_equal(contigs, want), "CFG-4 contig != genome")
    check(launches > 0, "CFG-4 main path never launched the kernel")
    stages = {name: round(s, 4) for name, s in m.stages.items()}
    log(f"CFG-4 on {mesh}: {wall:.3f} s wall, 1 contig == genome "
        f"({len(contigs[0])} bp), {windows} windows, {plan.num_batches} "
        f"batches of {plan.batch_total} reads, c_shard {plan.c_shard}, "
        f"bucket_cap {plan.bucket_cap}, kernel launches {launches}, peak "
        f"device memory {peak} GiB per card")
    log("CFG-4 stages (s): " + json.dumps(stages))
    log("CFG-4 counters: " + json.dumps(
        {n: int(v) for n, v in m.counters.items()}))
    mini_bytes = plan.num_batches * dist._a2a_count_bytes_per_step(
        mesh.size, k, dist._bucket_cap_for(plan.per_dev * 70, mesh.size, k, 15),
        15)
    log(f"CFG-4 routed bytes: per-window {int(m.counters['a2a_bytes_count'])}"
        f" (run), minimizer m=15 {mini_bytes} (same plan, its buffer "
        f"shapes)")

    # the count alone, under the profiler: its idle share
    with tempfile.TemporaryDirectory() as tmp:
        mc = dist.Metrics()
        t0 = time.perf_counter()
        with metrics_mod.profiler_trace(tmp):
            with pipeline.timed_stage(mc, "count", mesh.devices):
                gathered = dist.distributed_count_table(
                    rs.codes, cfg, mesh, table_capacity=capacity)
        t_dist = mc.stages["count"]
        busy, span = metrics_mod.read_trace(tmp).busy_share("count")
    log(f"CFG-4 count on 4 shards under torch.profiler: {t_dist:.3f} s, "
        f"device busy {busy:.3f} s of {span:.3f} s, idle "
        f"{100 * (1 - busy / span):.1f}% (trace written and read in "
        f"{time.perf_counter() - t0 - t_dist:.1f} s)")
    t0 = time.perf_counter()
    single = pipeline.count_reads_device(rs.codes, cfg, device=dev,
                                         table_capacity=capacity)
    torch.cuda.synchronize(dev)
    t_single = time.perf_counter() - t0
    check(tables_equal(torch, gathered, single),
          "CFG-4: gathered 4-shard table != single-device table")
    log(f"CFG-4 gathered table == single-device table "
        f"({int(single.num_unique)} unique k-mers); count on 4 shards "
        f"{t_dist:.3f} s (profiled), on one device {t_single:.3f} s")
    del gathered, single

    # routing share of one streamed batch, at the run's shapes
    packed, _, nv = dist._stream_batch(mesh, rs.codes, plan, 0, False)
    owned = dist._make_owned_keys(mesh, k, 100, plan.bucket_cap, None)
    step = dist.make_distributed_stream_count(mesh, k, plan.per_dev, 100,
                                              plan.bucket_cap)
    tables = [count_torch.empty_table(plan.c_shard, 1, d_)
              for d_ in mesh.devices]
    route_ms = time_cuda(torch, lambda: owned(packed, nv), 5)
    step_ms = time_cuda(torch, lambda: step(tables, packed, nv), 5)
    log(f"CFG-4 one streamed batch ({plan.batch_total} reads on 4 shards): "
        f"route {route_ms:.3f} ms of {step_ms:.3f} ms with the merge "
        f"({100 * route_ms / step_ms:.1f}%)")
    del packed, tables
    single = {"wall_s": round(wall, 3), "stages_s": stages, "peak_gib": peak}
    return launches, err, (rs.codes, cfg, capacity, contigs), single


def doubling_numbers(counters) -> dict:
    """Query rounds of a sharded-graph run and the seconds of one round of
    its doubling loops, from the run's counters."""
    rounds = int(counters["compress_doubling_rounds"])
    return {
        "query_rounds": int(counters["a2a_compress_query_rounds"]),
        "doubling_rounds": rounds,
        "s_a_doubling_round": round(
            counters["compress_doubling_s"] / max(rounds, 1), 5),
    }


def phase_cfg4_sharded(torch, ref, dist, mesh_mod, kmer, reads, cfg,
                       capacity, gathered, keep):
    """CFG-4 through the sharded graph on 4 shards with a "hash_shards"
    checkpoint (left in ``keep`` for phase 13), then resumed from it with
    zeroed reads."""
    import numpy as np

    mesh = mesh_mod.build_mesh(4)
    ck = os.path.join(keep, "cfg4_shards.npz")
    m = dist.Metrics()
    reset_launches(kmer)
    reset_peaks(torch, mesh)
    t0 = time.perf_counter()
    contigs = dist.assemble_distributed_sharded(
        reads, cfg, mesh, metrics=m, table_capacity=capacity,
        checkpoint=ck,
    )
    wall = time.perf_counter() - t0
    launches = kmer.extract_canonical_flat.launches
    check(tally_packs(kmer, "cfg4_sharded_graph") > 0,
          "CFG-4 sharded graph never launched the pack kernel")
    peak = peaks_gib(torch, mesh)
    check(len(contigs) == 1,
          f"CFG-4 sharded graph: {len(contigs)} contigs, expected 1")
    check(ref.contigs_equal(contigs, gathered),
          "CFG-4 sharded graph contig != the gathered path's (genome)")
    check(launches > 0, "CFG-4 sharded graph never launched the kernel")
    stages = {name: round(s, 4) for name, s in m.stages.items()}
    log(f"CFG-4 sharded graph on {mesh}: {wall:.3f} s wall incl. the "
        f"checkpoint write, 1 contig == genome == gathered path's, kernel "
        f"launches {launches}, peak device memory {peak} GiB per card")
    log("CFG-4 sharded graph stages (s): " + json.dumps(stages))
    log("CFG-4 sharded graph counters: " + json.dumps(
        {n: int(v) for n, v in m.counters.items()}))
    log(f"CFG-4 sharded graph query rounds run: "
        f"{int(m.counters['a2a_compress_query_rounds'])} (cap "
        f"{int(m.counters['a2a_compress_query_rounds_max'])} a pass)")
    single = {"wall_s": round(wall, 3), "stages_s": stages,
              "peak_gib": peak, **doubling_numbers(m.counters)}

    m = dist.Metrics()
    t0 = time.perf_counter()
    resumed = dist.assemble_distributed_sharded(
        np.zeros_like(reads), cfg, mesh, metrics=m,
        table_capacity=capacity, resume_from=ck,
    )
    check(resumed == contigs,
          "CFG-4 sharded graph resumed from its checkpoint != first run")
    stages = {name: round(s, 4) for name, s in m.stages.items()}
    log(f"CFG-4 sharded graph resumed from its hash_shards checkpoint "
        f"with zeroed reads: same contig, {time.perf_counter() - t0:.3f} "
        f"s; stages (s): {json.dumps(stages)}")
    return launches, ck, single


def expect_stop(fn) -> None:
    """Run ``fn``, which must end in the counters' injected stop."""
    try:
        fn()
    except RuntimeError as e:
        check("fault injection" in str(e), f"unexpected error: {e}")
        return
    check(False, "the injected stop did not happen")


def phase_resume(torch, ref, pipeline, dist, mesh_mod, reads, capacity, dev):
    """CFG-2's reads stream in 9 batches (4 shards: 580k reads and 40.6M
    windows a shard, past DIST_STREAM_WINDOWS); stop after batch 5, resume
    from the batch-3 snapshot."""
    cfg = ref.AssemblyConfig(k=31, read_len=100)
    mesh = mesh_mod.build_mesh(4)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "mid.npz")
        runs = [
            ("one device", lambda **kw: pipeline.count_reads_device(
                reads, cfg, device=dev, table_capacity=capacity, **kw)),
            ("4 shards", lambda **kw: dist.distributed_count_table(
                reads, cfg, mesh, table_capacity=capacity, **kw)),
        ]
        for name, count in runs:
            full = count()
            expect_stop(lambda: count(stream_checkpoint=ck,
                                      stream_checkpoint_every=3,
                                      abort_after_batch=5))
            resumed = count(resume_stream_from=ck)
            check(tables_equal(torch, resumed, full),
                  f"{name}: resumed table != uninterrupted table")
            log(f"resume, {name}: stopped after 5 of 9 batches, resumed from "
                "the batch-3 snapshot, table equal to the uninterrupted run")
            del full, resumed


def profiled_count(torch, pipeline, metrics_mod, dev, count):
    """``count()`` as a ``count`` stage under ``torch.profiler``: (table,
    stage seconds, device-busy seconds, the stage's span in the trace)."""
    with tempfile.TemporaryDirectory() as tmp:
        m = pipeline.Metrics()
        with metrics_mod.profiler_trace(tmp):
            with pipeline.timed_stage(m, "count", dev):
                table = count()
        busy, span = metrics_mod.read_trace(tmp).busy_share("count")
    return table, m.stages["count"], busy, span


def phase_upload(torch, ref, pipeline, metrics_mod, kmer, reads, capacity,
                 dev):
    """CFG-2's reads through the upload ring against the plain upload."""
    import numpy as np

    cfg = ref.AssemblyConfig(k=31, read_len=100)
    batches = -(-reads.shape[0] // cfg.batch_reads)

    def count(rows, cfg_, **kw):
        return pipeline.count_reads_device(rows, cfg_, device=dev,
                                           table_capacity=capacity, **kw)

    reset_launches(kmer)
    t0 = time.perf_counter()
    ring = count(reads, cfg)
    torch.cuda.synchronize(dev)
    t_ring = time.perf_counter() - t0
    launches = kmer.extract_canonical_flat.launches
    check(launches == batches == tally_packs(kmer, "cfg2_upload_ring"),
          f"the ring run launched the kernel {launches} times and the pack "
          f"{kmer.pack_on_device.launches} times for {batches} batches")
    t0 = time.perf_counter()
    plain = count(reads, cfg, _plain_upload=True)
    torch.cuda.synchronize(dev)
    t_plain = time.perf_counter() - t0
    check(tables_equal(torch, ring, plain) and torch.equal(ring.limbs,
                                                           plain.limbs),
          "CFG-2: table through the upload ring != table by plain uploads")
    log(f"upload ring, CFG-2 ({batches} batches of {cfg.batch_reads} reads): "
        f"table bit-equal to the plain upload's ({int(ring.num_unique)} "
        f"unique k-mers), {launches} kernel launches; count {t_ring:.4f} s "
        f"through the ring, {t_plain:.4f} s by plain uploads")
    del ring, plain

    # Ns, and a batch size that leaves a short last batch
    noisy = reads.copy()
    rng = np.random.default_rng(77)
    noisy[rng.integers(0, noisy.shape[0], 200_000),
          rng.integers(0, 100, 200_000)] = 4
    cfg_n = ref.AssemblyConfig(k=31, read_len=100, batch_reads=250_000)
    check(noisy.shape[0] % 250_000 != 0, "the last batch is not short")
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    a = count(noisy, cfg_n, ambiguous_counts=counts)
    b = count(noisy, cfg_n, _plain_upload=True)
    check(tables_equal(torch, a, b) and torch.equal(a.limbs, b.limbs),
          "reads with Ns: table through the upload ring != plain uploads")
    from genome_assembler_tpu_torch.ops.kmer_ref import window_valid_np

    want = [int((~window_valid_np(noisy, 31)).sum()),
            -(-noisy.shape[0] // 250_000)]
    check(counts.tolist() == want, f"reads with Ns: the card counted "
          f"{counts.tolist()} masked windows and batches with an N, the "
          f"host {want}")
    log(f"upload ring, CFG-2's reads with 200,000 Ns in "
        f"{-(-noisy.shape[0] // 250_000)} batches of 250,000 (last "
        f"{noisy.shape[0] % 250_000}): table bit-equal to the plain "
        f"upload's ({int(a.num_unique)} unique k-mers)")
    del a, b, noisy

    for name, kw in (("upload ring", {}),
                     ("plain uploads", {"_plain_upload": True})):
        _, secs, busy, span = profiled_count(
            torch, pipeline, metrics_mod, dev, lambda: count(reads, cfg, **kw))
        log(f"CFG-2 count under torch.profiler, {name}: {secs:.4f} s, device "
            f"busy {busy:.4f} s of {span:.4f} s, idle "
            f"{100 * (1 - busy / span):.1f}%")

    # one batch, piece by piece
    b_, length = cfg.batch_reads, 100
    rows = reads[:b_]
    slot = torch.empty((b_, length), dtype=torch.uint8, pin_memory=True)
    buf = torch.empty((b_, length), dtype=torch.uint8, device=dev)
    fills = []
    for _ in range(5):
        t0 = time.perf_counter()
        np.copyto(slot.numpy(), rows)
        fills.append((time.perf_counter() - t0) * 1e3)
    copy_ms = time_cuda(torch, lambda: buf.copy_(slot, non_blocking=True), 10)
    table = count(reads[: 2 * b_], cfg)
    pack_ms = time_cuda(torch, lambda: pipeline.pack_on_device(buf), 10)

    def device_step():
        packed, ext = pipeline.pack_batch(buf)
        pipeline._stream_step(table, packed, length, 31, **ext)

    step_ms = time_cuda(torch, device_step, 5)
    log(f"one CFG-2 batch ({b_} x {length}): host fill of the pinned slot "
        f"{sorted(fills)[2]:.3f} ms, copy of {b_ * length} bytes "
        f"{copy_ms:.3f} ms, device pack {pack_ms:.3f} ms, device pack + "
        f"extraction + merge {step_ms:.3f} ms")
    return launches


def phase_accept(torch, acceptance, kmer):
    """The acceptance runners 0, 1, 2 and 5 at full size on the card."""
    reset_launches(kmer)

    def emit(r):
        log(f"accept: {r.to_json()}")

    t0 = time.perf_counter()
    results = acceptance.run([0, 1, 2, 5], on_result=emit, device="cuda")
    failed = [r.config for r in results if not r.passed]
    check(not failed, f"acceptance configs {failed} failed")
    log(f"accept 0, 1, 2, 5: all passed in {time.perf_counter() - t0:.1f} s")
    check(tally_packs(kmer, "accept_0_1_2_5") > 0,
          "the acceptance runners never launched the pack kernel")
    return kmer.extract_canonical_flat.launches


def phase_cli(metrics_mod):
    """simulate -> assemble (every output, a trace) -> stats, each a
    subprocess, at CFG-1's size."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    stage_names = {"count", "filter", "compress", "spell", "simplify",
                   "traverse"}
    with tempfile.TemporaryDirectory() as tmp:
        def ga_torch(*args):
            proc = subprocess.run(
                [sys.executable, "-m", "genome_assembler_tpu_torch.cli", *args],
                cwd=tmp, env=env, capture_output=True, text=True, timeout=300,
            )
            check(proc.returncode == 0, f"ga-torch {args[0]} exited "
                  f"{proc.returncode}: {proc.stderr[-2000:]}")
            return proc

        t0 = time.perf_counter()
        ga_torch("simulate", "--genome-len", "48502", "--genome-seed", "1020",
                 "--coverage", "100", "--error-rate", "0.01", "--read-seed",
                 "1021", "--out", "reads.txt", "--genome-out", "genome.fa")
        asm = ga_torch("assemble", "--reads", "reads.txt", "-k", "31",
                       "--min-count", "5", "--out", "contigs.fa", "--gfa",
                       "graph.gfa", "--stats", "--metrics-out", "m.json",
                       "--trace-dir", "trace")
        stats = ga_torch("stats", "contigs.fa")
        line = json.loads(stats.stdout)
        check(line["contigs"] >= 1 and line["total_bp"] > 45_000,
              f"ga-torch stats: {stats.stdout.strip()}")
        check(stats.stdout.strip() in asm.stderr,
              "assemble --stats and stats disagree")
        with open(os.path.join(tmp, "graph.gfa")) as fh:
            check(fh.readline().startswith("H\t"), "the GFA has no header")
        trace = metrics_mod.read_trace(os.path.join(tmp, "trace"))
        check(stage_names <= set(trace.stages),
              f"trace stages: {sorted(trace.stages)}")
        kernels = trace.kernel_names()
        check(any("extract_canonical" in n for n in kernels),
              f"no extraction kernel in the trace: {sorted(kernels)[:10]}")
        busy, span = trace.busy_share("count")
        with open(os.path.join(tmp, "m.json")) as fh:
            report = json.load(fh)
        check({"stages_s", "counters", "derived"} <= set(report),
              f"--metrics-out keys: {sorted(report)}")
        frac = report["derived"]["hbm_roofline_frac"]
        check(report["derived"]["count_bytes_per_s"] > 0 and 0 <= frac < 1,
              f"derived: {report['derived']}")
        check(report["device"] == "cuda:0", f"device: {report['device']}")
        log(f"CLI: simulate -> assemble -> stats in "
            f"{time.perf_counter() - t0:.1f} s; {stats.stdout.strip()}; "
            f"trace: {len(trace.device)} device events, "
            f"{len(kernels)} kernel names, count busy {busy:.4f} s of "
            f"{span:.4f} s; derived: {json.dumps(report['derived'])}")


RANKS_LIMIT_S = 420.0  # a rank that hangs ends phase 13 after this


def phase_multiprocess(torch, ref, launch, reads, capacity, contigs, ck8,
                       single_gathered, single_sharded, tmp):
    """Phase 13: CFG-4 at full size as one NCCL rank a card through the
    command line, against phases 7-8 of this run."""
    import numpy as np

    from genome_assembler_tpu_torch.utils import io_native

    cards = torch.cuda.device_count()
    ranks = min(4, cards)
    cross = ranks > 1
    t0 = time.perf_counter()
    reads_file = os.path.join(tmp, "cfg4_reads.txt")
    launch.write_reads_lines(reads_file, reads)
    check(io_native.available(), "the native read loader did not build")
    log(f"multi-process CFG-4: {reads.shape[0]} reads written to a lines "
        f"file of {os.path.getsize(reads_file)} bytes in "
        f"{time.perf_counter() - t0:.1f} s; {ranks} rank(s) on {cards} "
        f"visible card(s)")
    ck13 = os.path.join(tmp, "cfg4_ranks_shards.npz")
    runs = {}
    launches = 0
    for name, extra in (
        ("sharded_graph", ["--sharded-graph", "--checkpoint", ck13]),
        ("gathered", []),
    ):
        out = os.path.join(tmp, f"ranks_{name}.fa")
        mfile = os.path.join(tmp, f"ranks_{name}.json")
        res = launch.spawn(
            ranks,
            ["assemble", "--reads", reads_file, "-k", "31", "--backend",
             "dist", "--devices", "4", "--hosts", str(ranks),
             "--table-capacity", str(capacity), "--out", out,
             "--metrics-out", mfile, *extra],
            device="cuda", timeout_s=RANKS_LIMIT_S,
        )
        check(res.ok, f"multi-process CFG-4, {name}: " + res.describe())
        paths = [out if r == 0 else f"{out}.rank{r}" for r in range(ranks)]
        texts = []
        for path in paths:
            with open(path) as fh:
                texts.append(fh.read())
        check(all(t == texts[0] for t in texts),
              f"multi-process CFG-4, {name}: the ranks' --out files differ")
        got = ["".join(texts[0].split("\n")[1:])]
        check(texts[0].count(">") == 1,
              f"multi-process CFG-4, {name}: {texts[0].count('>')} contigs")
        check(ref.contigs_equal(got, contigs),
              f"multi-process CFG-4, {name}: contig != genome (phase 8's)")
        reports = []
        for r in range(ranks):
            with open(mfile if r == 0 else f"{mfile}.rank{r}") as fh:
                reports.append(json.load(fh))
        for r, rep in enumerate(reports):
            check(rep["hosts"] == ranks and rep["counters"]["hosts"] == ranks,
                  f"{name}: rank {r} reports hosts {rep['hosts']}")
            check(rep["device"] == f"cuda:{r}" and rep["rank"] == r,
                  f"{name}: rank {r} ran on {rep['device']}")
            check(rep["kernel_launches"] > 0 and rep["pack_launches"] > 0,
                  f"{name}: rank {r} never launched the kernels")
        launches += sum(rep["kernel_launches"] for rep in reports)
        PACK_LAUNCHES["cfg4_multiprocess"] = PACK_LAUNCHES.get(
            "cfg4_multiprocess", 0) + sum(rep["pack_launches"]
                                          for rep in reports)
        r0 = reports[0]
        runs[name] = {
            "spawn_s": round(res.seconds, 3),
            "rank0_wall_s": round(r0["wall_s"], 3),
            "stages_s": r0["stages_s"],
            "pipeline_s": round(sum(r0["stages_s"].values()), 4),
            "peak_gib": [round(rep["peak_device_bytes"] / 2**30, 2)
                         for rep in reports],
            "h2d_bytes_reads_rank0": int(r0["counters"]["h2d_bytes_reads"]),
            "kernel_launches": [rep["kernel_launches"] for rep in reports],
        }
        if name == "sharded_graph":
            runs[name].update(doubling_numbers(r0["counters"]))
    t0 = time.perf_counter()
    with np.load(ck8) as a, np.load(ck13) as b:
        check(sorted(a.files) == sorted(b.files),
              f"checkpoint arrays: {sorted(a.files)} vs {sorted(b.files)}")
        for key in a.files:
            check(a[key].dtype == b[key].dtype
                  and np.array_equal(a[key], b[key]),
                  f"the ranks' hash_shards checkpoint differs from the "
                  f"single-process one in {key!r}")
        n_arrays = len(a.files)
    log(f"multi-process CFG-4: the ranks' hash_shards checkpoint equals the "
        f"single-process mesh's in all {n_arrays} arrays (compared in "
        f"{time.perf_counter() - t0:.1f} s); every rank wrote the same "
        f"contig, equal to the genome and to the single-process paths'")
    log("multi-process CFG-4: " + json.dumps({
        "ranks": ranks, "cards": cards, "cross_process": cross,
        "backend": "nccl", "shards": 4,
        # a rank is a new process: its stages hold the first-use costs
        "ranks_are": "cold processes", **runs,
        "single_process_sharded_graph": single_sharded,
        "single_process_gathered": single_gathered,
    }))
    if not cross:
        log("multi-process CFG-4: one card is visible, so this was one rank "
            "with four local shards through the same torch.distributed "
            "calls, not a run across processes")
    return launches


def filtered_table(pipeline, count_torch, reads, cfg, capacity, dev):
    """The filtered, compacted table ``assemble_torch`` hands to
    ``compress_unitigs_device``."""
    t = pipeline.count_reads_device(reads, cfg, device=dev,
                                    table_capacity=capacity)
    t = count_torch.compact_table(t)
    t = count_torch.filter_table(t, cfg.min_count or pipeline.auto_min_count(t))
    return count_torch.compact_table(t)


def check_equal_fields(torch, got, want, fields, what) -> None:
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, list):
            same = all(torch.equal(x, y) for x, y in zip(a, b))
        else:
            same = torch.equal(a, b) if torch.is_tensor(a) else a == b
        check(same, f"{what}: {f} differs")


UNITIG_FIELDS = ("edge_limbs", "cov", "uid", "pos", "valid", "num_unitigs")
SHARDED_FIELDS = ("valid", "uid", "pos", "cov", "last_base", "heads",
                  "edge_limbs", "num_unitigs", "overflow")


def timed_compress(torch, fn, tables, reps=3):
    """(outputs, seconds of each of ``reps`` warm calls) of a sharded
    compress step (its loops read the host, so wall clock is the time)."""
    out = fn(tables)
    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(tables)
        torch.cuda.synchronize()
        secs.append(round(time.perf_counter() - t0, 4))
    return out, secs


def sharded_numbers(g, secs) -> dict:
    return {"rank_pass": g.rank_pass, "query_rounds": g.query_rounds,
            "doubling_rounds": g.doubling_rounds,
            "contracted_rounds": g.contracted_rounds,
            "doubling_s": round(g.doubling_seconds, 4), "compress_s": secs}


def phase_ranking(torch, ref, pipeline, dist, mesh_mod, launch, cfg2_reads,
                  cfg2_cap, cfg4, reads_file, dev, tmp):
    """Phase 14: the sampled ranking against the exact pass on CFG-2,
    CFG-5 and CFG-4 sharded."""
    from genome_assembler_tpu_torch.ops import count_torch, unitig_torch
    from genome_assembler_tpu_torch.parallel import compress
    from genome_assembler_tpu_torch.utils.keys import snug_capacity

    k = 31
    cfg = ref.AssemblyConfig(k=k, read_len=100)
    table = filtered_table(pipeline, count_torch, cfg2_reads, cfg, cfg2_cap,
                           dev)
    rs, re = {}, {}
    got = unitig_torch.compress_unitigs_device(table, k, rounds=rs)
    want = unitig_torch.compress_unitigs_device(table, k, rounds=re,
                                                _exact=True)
    rows = got.edge_limbs.shape[0]
    check(rs["pass"] == "sampled" and rows >= unitig_torch.SAMPLED_MIN_ROWS,
          f"CFG-2 compress took the {rs['pass']} pass at {rows} edge rows")
    check_equal_fields(torch, got, want, UNITIG_FIELDS,
                       "CFG-2 sampled vs exact")
    whole = {
        "sampled": time_cuda(torch, lambda: unitig_torch.compress_unitigs_device(
            table, k), 3),
        "exact": time_cuda(torch, lambda: unitig_torch.compress_unitigs_device(
            table, k, _exact=True), 3),
    }
    edges, _, valid = unitig_torch._build_edges(table, k)
    prev = unitig_torch._link_sortjoin(edges, valid, k)
    alone = {
        "sampled": time_cuda(torch, lambda: unitig_torch._resolve_chains(
            prev, valid), 3),
        "exact": time_cuda(torch, lambda: unitig_torch._resolve_chains(
            prev, valid, exact=True), 3),
    }
    log("ranking, CFG-2: " + json.dumps({
        "edge_rows": rows, "unitigs": int(got.num_unitigs),
        "sampled_rounds_a": rs["a"], "sampled_rounds_b": rs["b"],
        "exact_rounds": re["exact"], "bit_equal": True,
        "compress_ms": {n: round(v, 3) for n, v in whole.items()},
        "ranking_ms": {n: round(v, 3) for n, v in alone.items()}}))
    del got, want, edges, prev, valid, table

    # CFG-5: the circular genome's graph is one cycle a strand
    glen = 4_641_652
    genome = ref.simulate_genome(glen, seed=1060)
    rs5 = ref.simulate_reads(genome, coverage=50, read_len=100, seed=1061,
                             tile_k=k, circular=True)
    table = filtered_table(pipeline, count_torch, rs5.codes, cfg,
                           snug_capacity(int(1.1 * glen) + 4096), dev)
    del rs5
    edges, _, valid = unitig_torch._build_edges(table, k)
    prev = unitig_torch._link_sortjoin(edges, valid, k)
    _, _, ok = unitig_torch._rank_sampled(prev)
    check(not ok, "CFG-5: the sampled pass accepted a circular graph")
    rc = {}
    head, rank, ok, prev3 = unitig_torch._rank_sampled_cyclic(prev, rc)
    check(ok, "CFG-5: the cyclic pass refused the circular graph")
    cyc = unitig_torch._finalize_chains(prev3, head, rank, valid)
    exact = unitig_torch._resolve_exact(prev, valid)
    check(all(torch.equal(a, b) for a, b in zip(cyc, exact)),
          "CFG-5: the cyclic pass != the exact pass")
    r5 = {}
    unitig_torch.compress_unitigs_device(table, k, rounds=r5)
    check(r5["pass"] == "cyclic", f"CFG-5 compress took {r5['pass']}")
    log("ranking, CFG-5: " + json.dumps({
        "edge_rows": int(prev.shape[0]), "unitigs": int(cyc[2]),
        "sampled_ok": False, "cyclic_ok": True, "equal_to_exact": True,
        "cyclic_rounds": rc,
        "ranking_ms": {
            "sampled_then_cyclic": round(time_cuda(
                torch, lambda: unitig_torch._resolve_chains(prev, valid), 3), 3),
            "exact": round(time_cuda(torch, lambda: unitig_torch._resolve_chains(
                prev, valid, exact=True), 3), 3)}}))
    del table, edges, prev, prev3, valid, head, rank, cyc, exact

    # CFG-4 through the sharded graph, one process
    reads, cfg4, capacity, _ = cfg4
    mesh = mesh_mod.build_mesh(4)
    tables = dist._run_distributed_step(reads, cfg4, mesh,
                                        table_capacity=capacity)
    tables, c_shard, _ = dist.filter_shards(mesh, tables, cfg4)
    runs = {name: timed_compress(torch, compress.make_sharded_compress(
        mesh, k, c_shard, _exact=name == "exact"), tables)
        for name in ("sampled", "exact")}
    (gs, ss), (ge, se) = runs["sampled"], runs["exact"]
    check(gs.rank_pass == "sampled", "CFG-4 sharded: the sampled pass refused")
    check_equal_fields(torch, gs, ge, SHARDED_FIELDS,
                       "CFG-4 sharded sampled vs exact")
    check(gs.query_rounds < 26 and gs.query_rounds < ge.query_rounds,
          f"CFG-4 sharded: {gs.query_rounds} query rounds sampled, "
          f"{ge.query_rounds} exact")
    single = {"sampled": sharded_numbers(gs, ss),
              "exact": sharded_numbers(ge, se)}
    log("ranking, CFG-4 sharded graph on " + str(mesh) + ": " + json.dumps({
        "c_shard": c_shard, "edge_rows": 4 * 2 * c_shard,
        "outputs_equal": True, **single}))
    del gs, ge, tables, runs

    cards = torch.cuda.device_count()
    if cards < 2:
        log("ranking, CFG-4 across ranks: one card is visible, not run")
        return
    ranks = min(4, cards)
    out = os.path.join(tmp, "rank_compress.json")
    torch.cuda.empty_cache()
    res = launch.spawn(ranks, [reads_file, out, str(capacity)],
                       device="cuda", timeout_s=RANKS_LIMIT_S,
                       entry=(os.path.abspath(__file__), "--rank-compress"))
    check(res.ok, "ranking across ranks: " + res.describe())
    with open(out) as fh:
        across = json.load(fh)
    check(across["outputs_equal"], "ranking across ranks: sampled != exact")
    check(across["sampled"]["query_rounds"] < 26,
          f"ranking across ranks: {across['sampled']['query_rounds']} rounds")
    log(f"ranking, CFG-4 sharded graph as {ranks} NCCL ranks: "
        + json.dumps(across))


def rank_compress_job(reads_file: str, out: str, capacity: str,
                      device: str) -> int:
    """One rank of phase 14 across processes: count and filter CFG-4 on
    4 shards over the ranks, then the sharded compress sampled and forced
    exact, 3 warm calls each; rank 0 writes the numbers to ``out``."""
    import torch

    import genome_assembler_tpu_torch.reference as ref
    from genome_assembler_tpu_torch.cli import _load_reads
    from genome_assembler_tpu_torch.parallel import compress
    from genome_assembler_tpu_torch.parallel import mesh as mesh_mod
    from genome_assembler_tpu_torch.parallel import pipeline as dist

    mesh_mod.init_distributed("nccl" if device == "cuda" else "gloo")
    mesh = mesh_mod.build_mesh(4, devices=None if device == "cuda" else [device])
    reads = _load_reads(reads_file)
    cfg = ref.AssemblyConfig(k=31, read_len=reads.shape[1])
    tables = dist._run_distributed_step(reads, cfg, mesh,
                                        table_capacity=int(capacity))
    tables, c_shard, _ = dist.filter_shards(mesh, tables, cfg)
    sync = (torch.cuda.synchronize if device == "cuda" else lambda: None)
    runs = {}
    for name in ("sampled", "exact"):
        fn = compress.make_sharded_compress(mesh, 31, c_shard,
                                            _exact=name == "exact")
        g = fn(tables)
        secs = []
        for _ in range(3):
            mesh_mod.barrier(mesh)
            sync()
            t0 = time.perf_counter()
            g = fn(tables)
            sync()
            mesh_mod.barrier(mesh)
            secs.append(round(time.perf_counter() - t0, 4))
        runs[name] = (g, secs)
    (gs, ss), (ge, se) = runs["sampled"], runs["exact"]
    differ = [
        not all(torch.equal(getattr(gs, f)[i], getattr(ge, f)[i])
                for f in SHARDED_FIELDS[:7])
        for i in range(mesh.local_size)
    ]
    differ = mesh_mod.any_reduce(mesh, [
        torch.tensor(x, device=d_) for x, d_ in zip(differ, mesh.devices)])
    same = (not bool(differ) and gs.num_unitigs == ge.num_unitigs
            and gs.overflow == ge.overflow == 0)
    if mesh_mod.is_writer(mesh):
        with open(out, "w") as fh:
            json.dump({"ranks": mesh.hosts, "c_shard": c_shard,
                       "outputs_equal": same,
                       "sampled": sharded_numbers(gs, ss),
                       "exact": sharded_numbers(ge, se)}, fh)
    mesh_mod.barrier(mesh)
    mesh_mod.shutdown_distributed()
    return 0


def tables_bit_equal(torch, a, b) -> bool:
    """Whole tables equal, capacity, padding and flags included."""
    return (a.limbs.shape == b.limbs.shape and torch.equal(a.limbs, b.limbs)
            and torch.equal(a.counts, b.counts)
            and int(a.num_unique) == int(b.num_unique)
            and bool(a.overflow) == bool(b.overflow))


def phase_bucketed(torch, ref, pipeline, dist, mesh_mod, kmer, cfg4,
                   cfg2_reads, cfg2_cap, dev):
    """Phase 15: the bucketed streaming merge against the flat one on one
    device and on 4 shards; a bucketed stop and resume."""
    import numpy as np

    reads, cfg, capacity, _ = cfg4
    merge_windows = cfg.batch_reads * (100 - cfg.k + 1)
    check(pipeline.use_bucketed("auto", capacity + merge_windows),
          "CFG-4 on one device: auto did not pick the bucketed layout")
    plan = pipeline.bucket_plan(capacity, merge_windows, buckets=None,
                                accum=None)
    launches = {}

    def count(layout):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        t = pipeline.count_reads_device(reads, cfg, device=dev,
                                        table_capacity=capacity,
                                        bucketed=layout)
        torch.cuda.synchronize(dev)
        return t, round(time.perf_counter() - t0, 4)

    secs = {"off": [], "on": []}
    tables = {}
    for layout in ("off", "on", "off", "on"):
        if layout == "on" and not secs["on"]:
            reset_launches(kmer)
        tables[layout], s_ = count(layout)
        if layout == "on" and not secs["on"]:
            launches["cfg4_bucketed_one_device"] = (
                kmer.extract_canonical_flat.launches)
            tally_packs(kmer, "cfg4_bucketed_one_device")
        secs[layout].append(s_)
    check(tables_bit_equal(torch, tables["on"], tables["off"]),
          "CFG-4 on one device: bucketed table != flat table")
    check(launches["cfg4_bucketed_one_device"] == -(-reads.shape[0]
                                                    // cfg.batch_reads)
          == PACK_LAUNCHES["cfg4_bucketed_one_device"],
          "the bucketed count did not launch the kernels once a batch")
    log("bucketed, CFG-4 on one device: " + json.dumps({
        "merge_rows": capacity + merge_windows,
        "bound": pipeline.BUCKETED_MIN_MERGE_ROWS, "auto_picks": "on",
        "nb": plan.nb, "cb": plan.cb, "m": plan.m, "accum": plan.accum,
        "unique": int(tables["on"].num_unique), "bit_equal": True,
        "count_s": secs}))
    del tables

    # a bucketed stop and resume, CFG-2's reads, one device
    cfg2 = ref.AssemblyConfig(k=31, read_len=100)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "mid_bucketed.npz")
        kw = dict(device=dev, table_capacity=cfg2_cap, bucketed="on")
        full = pipeline.count_reads_device(cfg2_reads, cfg2, **kw)
        expect_stop(lambda: pipeline.count_reads_device(
            cfg2_reads, cfg2, stream_checkpoint=ck, stream_checkpoint_every=3,
            abort_after_batch=6, **kw))
        with np.load(ck) as z:
            at = int(z["next_start"]) // cfg2.batch_reads
            geometry = [int(z[n]) for n in ("nb", "cb", "m", "accum")]
        check(at == 4, f"the bucketed snapshot is at batch {at}, not the "
              "first merge after batch 3")
        resumed = pipeline.count_reads_device(cfg2_reads, cfg2,
                                              resume_stream_from=ck, **kw)
        check(tables_bit_equal(torch, resumed, full),
              "bucketed resume != uninterrupted bucketed run")
    log(f"bucketed resume, CFG-2's reads on one device: stopped after 6 of "
        f"9 batches, resumed from the snapshot after batch 4 (the first "
        f"merge after batch 3; nb, cb, m, accum {geometry}), table equal "
        f"to the uninterrupted run")
    del full, resumed

    # CFG-4 on 4 shards
    mesh = mesh_mod.build_mesh(4)
    shard_tables, shard_secs = {}, {}
    for layout in ("off", "on"):
        if layout == "on":
            reset_launches(kmer)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shard_tables[layout] = dist._run_distributed_step(
            reads, cfg, mesh, table_capacity=capacity, bucketed=layout)
        torch.cuda.synchronize()
        shard_secs[layout] = round(time.perf_counter() - t0, 4)
    launches["cfg4_bucketed_4_shards"] = kmer.extract_canonical_flat.launches
    check(launches["cfg4_bucketed_4_shards"] > 0
          and tally_packs(kmer, "cfg4_bucketed_4_shards") > 0,
          "the bucketed 4-shard count never launched the kernels")
    check(all(tables_bit_equal(torch, a, b) for a, b in
              zip(shard_tables["on"], shard_tables["off"])),
          "CFG-4 on 4 shards: bucketed shard tables != flat ones")
    splan = dist._StreamPlan(reads.shape[0], 100, cfg, 4, None, None,
                             capacity, "on")
    log("bucketed, CFG-4 on " + str(mesh) + ": " + json.dumps({
        "auto_picks": "on" if dist._StreamPlan(
            reads.shape[0], 100, cfg, 4, None, None,
            capacity).buckets else "off",
        "c_shard": splan.c_shard, **splan.buckets._asdict(),
        "shard_tables_bit_equal": True, "count_s": shard_secs}))
    return launches


def timed_count(torch, fn, kmer, devices):
    """(result, seconds, kernel launches, peak GiB) of one count: the
    launch counter and the peak statistics reset just before it."""
    for d_ in devices:
        torch.cuda.synchronize(d_)
        torch.cuda.reset_peak_memory_stats(d_)
    reset_launches(kmer)
    t0 = time.perf_counter()
    out = fn()
    for d_ in devices:
        torch.cuda.synchronize(d_)
    secs = round(time.perf_counter() - t0, 4)
    peak = max(torch.cuda.max_memory_allocated(d_) for d_ in devices)
    return out, secs, kmer.extract_canonical_flat.launches, round(
        peak / 2**30, 2)


def phase_stride(torch, ref, pipeline, dist, mesh_mod, kmer, cfg4,
                 cfg2_reads, cfg2_cap, dev):
    """Phase 16: deferred merges (merge stride) on one device and on 4
    shards against stride 1, and a strided stop, resume and reshard."""
    import numpy as np

    reads, cfg, capacity, _ = cfg4
    n_batches = -(-reads.shape[0] // cfg.batch_reads)
    bw = cfg.batch_reads * (100 - cfg.k + 1)
    launches = {"cfg4_strided_one_device": 0, "cfg4_strided_4_shards": 0}

    # (a) one device: strides 1, 2, 4, 8 flat (twice, the second time in
    # the reverse order, so no stride always runs first), then auto once
    base = None
    runs = {}
    order = [(s_, "off") for s_ in (1, 2, 4, 8)]
    order += order[::-1] + [(s_, "auto") for s_ in (1, 2, 4, 8)]
    for stride, layout in order:
        t, secs, n, peak = timed_count(torch, lambda: (
            pipeline.count_reads_device(
                reads, cfg, device=dev, table_capacity=capacity,
                bucketed=layout, merge_stride=stride)), kmer, [dev])
        check(n == n_batches == kmer.pack_on_device.launches,
              f"stride {stride} {layout}: {n} launches and "
              f"{kmer.pack_on_device.launches} packs for {n_batches} "
              f"batches")
        if base is None:
            base = t
        check(tables_bit_equal(torch, t, base),
              f"CFG-4 stride {stride}, {layout}: table != stride 1")
        if stride > 1:
            launches["cfg4_strided_one_device"] += n
            tally_packs(kmer, "cfg4_strided_one_device")
        r = runs.setdefault(f"{stride}/{layout}", {
            "stride": stride, "layout": layout,
            "auto_takes": "buckets" if pipeline.use_bucketed(
                "auto", capacity + stride * bw) else "flat",
            "merge_rows": capacity + stride * bw, "count_s": [],
            "peak_gib": peak})
        r["count_s"].append(secs)
        del t
    del base
    for r in runs.values():
        log("stride, CFG-4 on one device: " + json.dumps(r))

    # (b) 4 shards: stride 1 flat, then strides 2 and 4, auto and flat
    mesh = mesh_mod.build_mesh(4)
    base, secs, _, _ = timed_count(torch, lambda: dist._run_distributed_step(
        reads, cfg, mesh, table_capacity=capacity, bucketed="off"), kmer,
        mesh.devices)
    log(f"stride, CFG-4 on {mesh}: stride 1, flat: count_s {secs}")
    for stride in (2, 4):
        for layout in ("auto", "off"):
            plan = dist._StreamPlan(reads.shape[0], 100, cfg, 4, None, None,
                                    capacity, layout, merge_stride=stride)
            tables, secs, n, peak = timed_count(
                torch, lambda: dist._run_distributed_step(
                    reads, cfg, mesh, table_capacity=capacity,
                    bucketed=layout, merge_stride=stride), kmer,
                mesh.devices)
            launches["cfg4_strided_4_shards"] += n
            check(n == 4 * plan.num_batches
                  and tally_packs(kmer, "cfg4_strided_4_shards") > 0,
                  f"4 shards stride {stride}: {n} launches, "
                  f"{kmer.pack_on_device.launches} packs")
            check(all(tables_bit_equal(torch, a, b_)
                      for a, b_ in zip(tables, base)),
                  f"CFG-4 on 4 shards, stride {stride} {layout}: shard "
                  "tables != stride 1's")
            log(f"stride, CFG-4 on {mesh}: " + json.dumps({
                "stride": stride, "layout": layout,
                "takes": "buckets" if plan.buckets else "flat",
                "merge_rows": plan.c_shard + stride * plan.recv,
                "count_s": secs, "peak_gib": peak}))
            del tables
    del base

    # (c) a strided stop and resume on CFG-2's reads, and a reshard
    cfg2 = ref.AssemblyConfig(k=31, read_len=100)
    mesh2 = mesh_mod.build_mesh(2)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "mid.npz")
        counts = [
            ("one device", lambda **kw: pipeline.count_reads_device(
                cfg2_reads, cfg2, device=dev, table_capacity=cfg2_cap,
                merge_stride=3, **kw)),
            ("4 shards", lambda **kw: dist.distributed_count_table(
                cfg2_reads, cfg2, mesh, table_capacity=cfg2_cap,
                merge_stride=3, **kw)),
        ]
        for name, count in counts:
            full = count()
            expect_stop(lambda: count(stream_checkpoint=ck,
                                      stream_checkpoint_every=2,
                                      abort_after_batch=5))
            with np.load(ck) as z:
                at = int(z["next_start" if name == "one device"
                           else "next_batch"])
            at = at // cfg2.batch_reads if name == "one device" else at
            check(at == 3, f"strided snapshot, {name}: after batch {at}")
            check(tables_equal(torch, count(resume_stream_from=ck), full),
                  f"strided resume, {name}: table != uninterrupted")
            log(f"stride resume, CFG-2's reads, {name}, stride 3: stopped "
                "after 5 of 9 batches, resumed from the snapshot after "
                "batch 3 (the first merge once 2 batches had passed), "
                "table equal to the uninterrupted run")
        ck2 = os.path.join(tmp, "mid2.npz")
        t0 = time.perf_counter()
        dist.reshard_sharded_stream_checkpoint(
            ck, ck2, cfg2_reads.shape, cfg2, 2, table_capacity=cfg2_cap,
            merge_stride=3)
        t_reshard = time.perf_counter() - t0
        resumed = dist.distributed_count_table(
            cfg2_reads, cfg2, mesh2, table_capacity=cfg2_cap,
            merge_stride=3, resume_stream_from=ck2)
        n = int(full.num_unique)
        check(int(resumed.num_unique) == n
              and torch.equal(resumed.limbs[:n], full.limbs[:n])
              and torch.equal(resumed.counts[:n], full.counts[:n]),
              "strided reshard 4 -> 2: resumed table != uninterrupted")
        log(f"stride reshard, CFG-2's reads: the 4-shard stride-3 snapshot "
            f"resharded to 2 shards in {t_reshard:.2f} s, resumed on "
            f"{mesh2} to the uninterrupted table")
        del full, resumed
    return launches


def run_entry_point(args: list[str], limit_s: float) -> tuple[dict, float]:
    """One entry point of the checkout as a subprocess from its root:
    (its JSON line, seconds). The line is printed as it came."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=root,
                          capture_output=True, text=True, timeout=limit_s)
    check(proc.returncode == 0, f"{' '.join(args)} exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    log(line)
    return json.loads(line), time.perf_counter() - t0


def phase_entry_points() -> dict:
    """Phase 17: bench_torch.py at its defaults and the 40 Mb run of
    tools/run_large_torch.py on the card; returns their main-path launches."""
    t0 = time.perf_counter()
    bench, bench_s = run_entry_point(["bench_torch.py"], 600)
    d = bench["detail"]
    check(d["backend"] == "cuda" and bench["value"] > 0,
          f"bench_torch: backend {d['backend']}, value {bench['value']}")
    check(d["exact_match"] is True, "bench_torch: contigs != genome")
    check(d["extract_equal"] is True and d["stream_table_equal"] is True,
          "bench_torch: kernel or streamed table differ from the plain ones")
    frac = d["min_traffic_roofline_frac"]
    check(0 < frac < 1, f"bench_torch: min_traffic_roofline_frac {frac}")
    ratio = d["extract_kernel_s"] / d["extract_bound_s"]
    check(ratio < 10, f"bench_torch: kernel at {ratio:.2f}x its bound")
    log(f"bench_torch: {bench['value']:.6g} kmers/s "
        f"({bench['vs_baseline']:.6g}x the dict counter), best "
        f"{d['best_s']:.6g} s, sort floor {d['sort_floor_s']:.6g} s "
        f"({d['frac_of_sort_floor']:.4f} of the count), kernel "
        f"{d['extract_kernel_s'] * 1e3:.4f} ms = {ratio:.2f}x its bound; "
        f"{bench_s:.1f} s")
    large, large_s = run_entry_point(
        [os.path.join("tools", "run_large_torch.py"), "40", "25", "31",
         "--reps", "1"], 900)
    check(large["exact_single_contig"] is True
          and large["exact_kmer_content"] is True,
          f"40 Mb run: exact_single_contig {large['exact_single_contig']}, "
          f"exact_kmer_content {large['exact_kmer_content']}")
    check(large["contigs"] == 1 and large["n50"] == 40_000_000,
          f"40 Mb run: {large['contigs']} contigs, n50 {large['n50']}")
    batches = -(-large["reads"] // 262_144)
    check(large["extract_launches"] == 2 * batches == large["pack_launches"],
          f"40 Mb run: {large['extract_launches']} launches and "
          f"{large['pack_launches']} packs for two runs of {batches} batches")
    PACK_LAUNCHES["bench_torch"] = sum(d["pack_launches"].values())
    PACK_LAUNCHES["run_large_40mb"] = large["pack_launches"]
    check(PACK_LAUNCHES["bench_torch"] > 0,
          "bench_torch never launched the pack kernel")
    log(f"40 Mb run: cold {large['cold_s']:.6g} s, warm {large['warm_s']:.6g}"
        f" s, peak {large['peak_gib']:.4g} GiB, "
        f"{'bucketed' if large['bucketed'] else 'flat'} at "
        f"{large['merge_rows']} rows a merge; {large_s:.1f} s")
    log(f"phase 17: {time.perf_counter() - t0:.1f} s")
    return {
        "bench_torch": sum(n for leg, n in d["extract_launches"].items()
                           if leg != "extraction"),
        "run_large_40mb": large["extract_launches"],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import genome_assembler_tpu_torch.reference as ref
    from genome_assembler_tpu_torch.models import acceptance, pipeline
    from genome_assembler_tpu_torch.ops import _build, kmer_torch as kmer
    from genome_assembler_tpu_torch.parallel import launch
    from genome_assembler_tpu_torch.parallel import mesh as mesh_mod
    from genome_assembler_tpu_torch.parallel import pipeline as dist
    from genome_assembler_tpu_torch.utils import metrics as metrics_mod

    dev = torch.device("cuda", 0)
    kind = card_info(torch)

    t0 = time.perf_counter()
    lib = _build.build("kmer_extract")
    _build.kmer_extract_fn()
    _build.pack_reads_fn()
    log(f"built {KERNEL_SOURCE} (extraction and pack) -> {lib} in "
        f"{time.perf_counter() - t0:.2f} s")

    err, times = phase_kernel(torch, ref, kmer, dev)
    pack_times = phase_pack(torch, ref, kmer, dev)
    phase_oracle(torch, ref, pipeline, dev)
    by_path = {}
    by_path["cfg2"], cfg2_reads, cfg2_cap = phase_cfg2(torch, ref, pipeline,
                                                       kmer, dev)
    phase_mesh_cfg1(torch, ref, dist, mesh_mod)
    by_path["cfg4_gathered"], cfg4_err, cfg4, single_gathered = phase_cfg4(
        torch, ref, pipeline, dist, mesh_mod, metrics_mod, kmer, dev)
    err = max(err, cfg4_err)
    keep = tempfile.TemporaryDirectory()  # phase 8's checkpoint, phase 13's files
    by_path["cfg4_sharded_graph"], ck8, single_sharded = phase_cfg4_sharded(
        torch, ref, dist, mesh_mod, kmer, *cfg4, keep.name)
    phase_resume(torch, ref, pipeline, dist, mesh_mod, cfg2_reads, cfg2_cap,
                 dev)
    by_path["cfg2_upload_ring"] = phase_upload(
        torch, ref, pipeline, metrics_mod, kmer, cfg2_reads, cfg2_cap, dev)
    by_path["accept_0_1_2_5"] = phase_accept(torch, acceptance, kmer)
    phase_cli(metrics_mod)
    cfg4_reads, _, cfg4_cap, cfg4_contigs = cfg4
    torch.cuda.empty_cache()  # the ranks share card 0 with this process
    by_path["cfg4_multiprocess"] = phase_multiprocess(
        torch, ref, launch, cfg4_reads, cfg4_cap, cfg4_contigs, ck8,
        single_gathered, single_sharded, keep.name)
    phase_ranking(torch, ref, pipeline, dist, mesh_mod, launch, cfg2_reads,
                  cfg2_cap, cfg4, os.path.join(keep.name, "cfg4_reads.txt"),
                  dev, keep.name)
    keep.cleanup()
    by_path.update(phase_bucketed(torch, ref, pipeline, dist, mesh_mod, kmer,
                                  cfg4, cfg2_reads, cfg2_cap, dev))
    by_path.update(phase_stride(torch, ref, pipeline, dist, mesh_mod, kmer,
                                cfg4, cfg2_reads, cfg2_cap, dev))
    del cfg4, cfg4_reads, cfg2_reads
    torch.cuda.empty_cache()  # the entry points run as processes of their own
    by_path.update(phase_entry_points())
    foreign = sorted(
        name for name in sys.modules
        if name == "jax" or name.startswith("jax.")
        or name == "genome_assembler_tpu"
        or name.startswith("genome_assembler_tpu.")
    )
    check(not foreign, f"JAX or the JAX package was imported: {foreign[:5]}")

    print(json.dumps({"kernels": [{
        "name": "kmer_extract",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": err,
        **times,
        # no single PyTorch call computes the canonical k-mers of packed reads
        "library_ms": None,
    }, {
        "name": "pack_reads",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": None,
        "launches": sum(PACK_LAUNCHES.values()),
        "launches_by_path": PACK_LAUNCHES,
        "max_abs_err": 0,
        **pack_times,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-compress"]:
        # a rank of phase 14: READS OUT CAPACITY --device DEVICE
        sys.exit(rank_compress_job(*sys.argv[2:5], sys.argv[6]))
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
