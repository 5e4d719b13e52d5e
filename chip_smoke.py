#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``genome_assembler_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

  1. the card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
     power limit;
  2. build the extraction kernel from ``genome_assembler_tpu_torch/csrc``;
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
     kernels and stage names, and ``derived.hbm_roofline_frac`` < 1.

The line before the last is the kernel report (launches summed over the
main-path runs: CFG-2, CFG-4 gathered, CFG-4 sharded graph, the upload
phase's ring run and the acceptance runners, and
given for each in ``launches_by_path``); the last line is
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# No integer rate is published; the float32 rate outside the tensor cores
# stands in (half of it would not change which bound is the larger).
INT_OPS_PER_S = 67e12
OPS_PER_WINDOW_LIMB = 8  # 2 shifts, 2 ors, mask, complement, compare, select

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
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    log(f"device: {name}")
    log(line)
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


def kernel_bound_ms(b, length, k, with_inv):
    """The least time the card could take for one extraction: the larger
    of bytes over the memory rate (packed codes and invalid bits read
    once, key limbs written once) and integer operations over their
    rate. Returns (ms, "bytes" or "operations", bytes)."""
    limbs = 1 if k <= 31 else 2
    windows = b * (length - k + 1)
    nbytes = windows * limbs * 8 + b * ((length + 3) // 4)
    if with_inv:
        nbytes += b * ((length + 7) // 8)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = windows * limbs * OPS_PER_WINDOW_LIMB / INT_OPS_PER_S * 1e3
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", nbytes
    return ops_ms, "operations", nbytes


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
    bound_ms, bound_by, nbytes = kernel_bound_ms(b, length, k, False)
    windows = b * (length - k + 1)
    log(f"kernel main batch {b}x{length} k={k}: bit-equal; kernel "
        f"{ms:.4f} ms ({windows / ms / 1e6:.1f} G windows/s, "
        f"{nbytes / ms / 1e9:.3f} TB/s), bound {bound_ms:.4f} ms ({nbytes} "
        f"bytes at {HBM_BYTES_PER_S / 1e12} TB/s; {ms / bound_ms:.2f}x), "
        f"plain torch {plain_ms:.4f} ms")
    return worst, {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by}


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
    kmer.extract_canonical_flat.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    contigs = pipeline.assemble_torch(rs.codes, cfg, device=dev,
                                      table_capacity=capacity, metrics=m)
    wall = time.perf_counter() - t0
    launches = kmer.extract_canonical_flat.launches
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
    kmer.extract_canonical_flat.launches = 0
    reset_peaks(torch, mesh)
    t0 = time.perf_counter()
    contigs = dist.assemble_distributed(rs.codes, cfg, mesh, metrics=m,
                                        table_capacity=capacity)
    wall = time.perf_counter() - t0
    launches = kmer.extract_canonical_flat.launches
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
    return launches, err, (rs.codes, cfg, capacity, contigs)


def phase_cfg4_sharded(torch, ref, dist, mesh_mod, kmer, reads, cfg,
                       capacity, gathered):
    """CFG-4 through the sharded graph on 4 shards with a "hash_shards"
    checkpoint, then resumed from it with zeroed reads."""
    import numpy as np

    mesh = mesh_mod.build_mesh(4)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "cfg4_shards.npz")
        m = dist.Metrics()
        kmer.extract_canonical_flat.launches = 0
        reset_peaks(torch, mesh)
        t0 = time.perf_counter()
        contigs = dist.assemble_distributed_sharded(
            reads, cfg, mesh, metrics=m, table_capacity=capacity,
            checkpoint=ck,
        )
        wall = time.perf_counter() - t0
        launches = kmer.extract_canonical_flat.launches
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
    return launches


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

    kmer.extract_canonical_flat.launches = 0
    t0 = time.perf_counter()
    ring = count(reads, cfg)
    torch.cuda.synchronize(dev)
    t_ring = time.perf_counter() - t0
    launches = kmer.extract_canonical_flat.launches
    check(launches == batches, f"the ring run launched the kernel "
          f"{launches} times for {batches} batches")
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
    a = count(noisy, cfg_n)
    b = count(noisy, cfg_n, _plain_upload=True)
    check(tables_equal(torch, a, b) and torch.equal(a.limbs, b.limbs),
          "reads with Ns: table through the upload ring != plain uploads")
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
    pack_ms = time_cuda(torch, lambda: pipeline.pack_on_device(buf, False), 10)

    def device_step():
        packed, inv = pipeline.pack_on_device(buf, False)
        pipeline._stream_step(table, packed, length, 31, inv)

    step_ms = time_cuda(torch, device_step, 5)
    log(f"one CFG-2 batch ({b_} x {length}): host fill of the pinned slot "
        f"{sorted(fills)[2]:.3f} ms, copy of {b_ * length} bytes "
        f"{copy_ms:.3f} ms, device pack {pack_ms:.3f} ms, device pack + "
        f"extraction + merge {step_ms:.3f} ms")
    return launches


def phase_accept(torch, acceptance, kmer):
    """The acceptance runners 0, 1, 2 and 5 at full size on the card."""
    kmer.extract_canonical_flat.launches = 0

    def emit(r):
        log(f"accept: {r.to_json()}")

    t0 = time.perf_counter()
    results = acceptance.run([0, 1, 2, 5], on_result=emit, device="cuda")
    failed = [r.config for r in results if not r.passed]
    check(not failed, f"acceptance configs {failed} failed")
    log(f"accept 0, 1, 2, 5: all passed in {time.perf_counter() - t0:.1f} s")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import genome_assembler_tpu_torch.reference as ref
    from genome_assembler_tpu_torch.models import acceptance, pipeline
    from genome_assembler_tpu_torch.ops import _build, kmer_torch as kmer
    from genome_assembler_tpu_torch.parallel import mesh as mesh_mod
    from genome_assembler_tpu_torch.parallel import pipeline as dist
    from genome_assembler_tpu_torch.utils import metrics as metrics_mod

    dev = torch.device("cuda", 0)
    kind = card_info(torch)

    t0 = time.perf_counter()
    lib = _build.build("kmer_extract")
    _build.kmer_extract_fn()
    log(f"built {KERNEL_SOURCE} -> {lib} in {time.perf_counter() - t0:.2f} s")

    err, times = phase_kernel(torch, ref, kmer, dev)
    phase_oracle(torch, ref, pipeline, dev)
    by_path = {}
    by_path["cfg2"], cfg2_reads, cfg2_cap = phase_cfg2(torch, ref, pipeline,
                                                       kmer, dev)
    phase_mesh_cfg1(torch, ref, dist, mesh_mod)
    by_path["cfg4_gathered"], cfg4_err, cfg4 = phase_cfg4(
        torch, ref, pipeline, dist, mesh_mod, metrics_mod, kmer, dev)
    err = max(err, cfg4_err)
    by_path["cfg4_sharded_graph"] = phase_cfg4_sharded(torch, ref, dist,
                                                       mesh_mod, kmer, *cfg4)
    del cfg4
    phase_resume(torch, ref, pipeline, dist, mesh_mod, cfg2_reads, cfg2_cap,
                 dev)
    by_path["cfg2_upload_ring"] = phase_upload(
        torch, ref, pipeline, metrics_mod, kmer, cfg2_reads, cfg2_cap, dev)
    del cfg2_reads
    by_path["accept_0_1_2_5"] = phase_accept(torch, acceptance, kmer)
    phase_cli(metrics_mod)
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
