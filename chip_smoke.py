#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``genome_assembler_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

  1. the card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
     power limit;
  2. build the extraction kernel from ``genome_assembler_tpu_torch/csrc``;
  3. the kernel against its plain torch version on the card, bit-equal:
     k in {21, 25, 31, 41, 63} with ambiguous bases and n_valid < B, and
     the main path's batch shape (262,144 reads x 100 bp, k=31); then both
     timed at that shape with CUDA events;
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
     and 4 shards): the resumed table equals the uninterrupted one.

The line before the last is the kernel report (launches summed over the
three main-path runs: CFG-2, CFG-4 gathered, CFG-4 sharded graph); the
last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
JAX is never imported.
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
    b, length, k = MAIN_BATCH
    reads = random_reads(rng, b, length, 0.0)
    packed, inv = upload_reads(torch, ref, reads, dev)
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
    windows = b * (length - k + 1)
    log(f"kernel main batch {b}x{length} k={k}: bit-equal; kernel "
        f"{ms:.4f} ms ({windows / ms / 1e6:.1f} G windows/s), plain torch "
        f"{plain_ms:.4f} ms")
    return worst, ms, plain_ms


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
    check(launches > 0, "CFG-2 main path never launched the kernel")
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


def phase_cfg4(torch, ref, pipeline, dist, mesh_mod, kmer, dev):
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

    t0 = time.perf_counter()
    gathered = dist.distributed_count_table(rs.codes, cfg, mesh,
                                            table_capacity=capacity)
    torch.cuda.synchronize(dev)
    t_dist = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = pipeline.count_reads_device(rs.codes, cfg, device=dev,
                                         table_capacity=capacity)
    torch.cuda.synchronize(dev)
    t_single = time.perf_counter() - t0
    check(tables_equal(torch, gathered, single),
          "CFG-4: gathered 4-shard table != single-device table")
    log(f"CFG-4 gathered table == single-device table "
        f"({int(single.num_unique)} unique k-mers); count on 4 shards "
        f"{t_dist:.3f} s, on one device {t_single:.3f} s")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import genome_assembler_tpu_torch.reference as ref
    from genome_assembler_tpu_torch.models import pipeline
    from genome_assembler_tpu_torch.ops import _build, kmer_torch as kmer
    from genome_assembler_tpu_torch.parallel import mesh as mesh_mod
    from genome_assembler_tpu_torch.parallel import pipeline as dist

    dev = torch.device("cuda", 0)
    kind = card_info(torch)

    t0 = time.perf_counter()
    lib = _build.build("kmer_extract")
    _build.kmer_extract_fn()
    log(f"built {KERNEL_SOURCE} -> {lib} in {time.perf_counter() - t0:.2f} s")

    err, ms, plain_ms = phase_kernel(torch, ref, kmer, dev)
    phase_oracle(torch, ref, pipeline, dev)
    launches, cfg2_reads, cfg2_cap = phase_cfg2(torch, ref, pipeline, kmer,
                                                dev)
    phase_mesh_cfg1(torch, ref, dist, mesh_mod)
    cfg4_launches, cfg4_err, cfg4 = phase_cfg4(torch, ref, pipeline, dist,
                                               mesh_mod, kmer, dev)
    launches += cfg4_launches
    err = max(err, cfg4_err)
    launches += phase_cfg4_sharded(torch, ref, dist, mesh_mod, kmer, *cfg4)
    del cfg4
    phase_resume(torch, ref, pipeline, dist, mesh_mod, cfg2_reads, cfg2_cap,
                 dev)
    check("jax" not in sys.modules, "JAX was imported")

    print(json.dumps({"kernels": [{
        "name": "kmer_extract",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
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
