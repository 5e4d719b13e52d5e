#!/usr/bin/env python3
"""Benchmark harness of the PyTorch/CUDA port: canonical k-mer counting
throughput on one GPU (the port of ``bench.py``).

    python3 bench_torch.py [--genome-len N] [--coverage X] [-k K] [--reps R]
                           [--baseline-windows W] [--device cuda|cpu]

Prints ONE JSON line of ``bench.py``'s shape:

  {"metric": "kmer_count_throughput", "value": <kmers/s>, "unit": "kmers/s",
   "vs_baseline": <speed-up over a Python dict counter>, "detail": {...}}

The workload is ``bench.py``'s: a 1,000,000 bp genome (seed 11), 100 bp
reads at 25x (seed 12), k=31: 250,000 reads and 17,500,000 windows.
``value`` is windows over the best of ``--reps`` counts, each one
``models.pipeline._count_batch`` (extraction kernel, sort, run-length
reduce) of the packed reads staged on the device before the clock starts,
closed by a device synchronise. ``vs_baseline`` divides it by the rate of
the port's ``models/oracle.py::count_canonical_dict`` (one dict upsert a
window, the reference assembler's hot loop) on ``--baseline-windows``
windows on the same machine.

``detail`` keeps every key of ``bench.py`` whose meaning carries over
(``backend``, ``device``, ``k``, ``reads``, ``windows``, ``best_s``,
``warmup_s``, ``host_to_device_s``, ``reference_python_kmers_per_s``,
``min_traffic_roofline_frac``, ``measured_stream_bw_gb_s``,
``frac_of_measured_bw``, ``sort_floor_s``, ``frac_of_sort_floor``,
``assemble_*``, ``contigs``, ``n50``, ``exact_match``, ``stream_count_s``,
``single_shot_with_transfer_s``, ``stream_vs_single_shot``) and adds the
card (``nvidia-smi``'s name and power limit), ``build_s`` (the kernel's
build, before the first timed region), the extraction kernel's launches
by leg and the pack kernel's (``pack_launches``), and the checks the run makes on the way (``extract_equal``,
``stream_table_equal``).

What ``bench.py`` built around its TPU, and what stands here instead:

* The relay probe, its retries and the fall-back to the CPU are gone.
  Without CUDA, and without ``--device cpu``, the run raises; a failure of
  the kernel, the streamed count or the assembly ends it. The one
  ``except`` left prints ``value: 0`` with ``"error"`` and exits 1.
* The slope-timed passes (``*_amortized*``) cancelled the relay's dispatch
  latency. CUDA events time the card directly, so
  ``measured_stream_bw_amortized_gb_s`` and ``frac_of_amortized_bw`` fold
  into ``measured_stream_bw_gb_s`` and ``frac_of_measured_bw``, and
  ``sort_floor_amortized_s``, ``sort_ns_per_row_amortized`` and
  ``frac_of_amortized_sort_floor`` into ``sort_floor_s``,
  ``sort_ns_per_row`` and ``frac_of_sort_floor``.
* Pallas against XLA (``extract_pallas_s``, ``extract_xla_s`` and their
  rates) becomes the CUDA kernel against its plain torch version at the
  bench's shape, beside the kernel's bound: ``extract_kernel_s``,
  ``extract_plain_s``, ``extract_bound_s`` (``ops/kmer_torch.py::
  kernel_bound_ms``).
* The sort floor times the sorts that ``count_torch.sort_by_words`` runs
  (one stable ``torch.sort`` a key limb: one for k <= 31), alone, on the
  key stream the extraction gave. The port's compaction is a scatter, not
  the second sort ``bench.py`` timed.
* ``min_traffic_roofline_frac`` counts the port's keys (``n_limbs(k)``
  int64 limbs, written once and read back once) against the H100's
  3.35 TB/s; it is null on the CPU.

Means over many calls (``extract_*``, the stream bandwidth, the sort
floor) come from CUDA events on a card and from the host clock on the
CPU. A CPU run checks the harness; its times are the CPU's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from genome_assembler_tpu_torch.host.stats import contig_stats
from genome_assembler_tpu_torch.host.traverse import contigs_equal
from genome_assembler_tpu_torch.models.oracle import count_canonical_dict
from genome_assembler_tpu_torch.models.pipeline import (
    _count_batch,
    assemble_torch,
    count_reads_device,
)
from genome_assembler_tpu_torch.ops import _build, kmer_torch as kmer
from genome_assembler_tpu_torch.utils.config import AssemblyConfig
from genome_assembler_tpu_torch.utils.device import (
    card_line,
    resolve_device,
    synchronize,
)
from genome_assembler_tpu_torch.utils.dna import (
    decode_seq,
    pack_codes,
    pack_invalid_mask,
)
from genome_assembler_tpu_torch.utils.keys import n_limbs, snug_capacity
from genome_assembler_tpu_torch.utils.metrics import HBM_PEAK_BYTES_S, Metrics
from genome_assembler_tpu_torch.utils.simulate import (
    simulate_genome,
    simulate_reads,
)

READ_LEN = 100
TIMED_CALLS = 20  # calls of one mean (kernel, stream, sort floor)
PLAIN_CALLS = 5  # the plain extraction is ~500x slower than the kernel


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="k-mer counting throughput of the port on one device"
    )
    ap.add_argument("--genome-len", type=int, default=1_000_000)
    ap.add_argument("--coverage", type=float, default=25.0)
    ap.add_argument("-k", type=int, default=31)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--baseline-windows", type=int, default=200_000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without CUDA) or cpu")
    return ap.parse_args(argv)


def workload(genome_len: int, coverage: float):
    """``bench.py``'s read set: (genome codes, [B, READ_LEN] read codes)."""
    genome = simulate_genome(genome_len, seed=11)
    rs = simulate_reads(genome, coverage=coverage, read_len=READ_LEN, seed=12)
    return genome, rs.codes


def count_once(packed, k, inv=None):
    """The timed function: extraction + count of staged packed reads."""
    return _count_batch(packed, READ_LEN, k, inv)


def timed_calls(dev, fn, reps):
    """(seconds of each of ``reps`` calls, the last result): each call
    timed by the host clock and closed by a device synchronise."""
    times, out = [], None
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        out = fn()
        synchronize(dev)
        times.append(time.perf_counter() - t0)
    return times, out


def mean_seconds(dev, fn, calls):
    """Mean seconds of one call of ``fn`` over ``calls`` calls after one
    warm-up call: between two CUDA events on a card, by the host clock on
    the CPU."""
    fn()
    synchronize(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) / calls
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / calls


def tables_equal(a, b) -> bool:
    """Two count tables hold the same keys and counts (capacities may
    differ)."""
    n = int(a.num_unique)
    return (n == int(b.num_unique) and not bool(a.overflow | b.overflow)
            and torch.equal(a.limbs[:n], b.limbs[:n])
            and torch.equal(a.counts[:n], b.counts[:n]))


def run(args: argparse.Namespace) -> dict:
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    card = card_line(dev)
    k = args.k
    kmer.extract_canonical_flat.launches = kmer.pack_on_device.launches = 0
    launches, pack_launches = {}, {}

    def tally(leg):
        launches[leg] = (kmer.extract_canonical_flat.launches
                         - sum(launches.values()))
        pack_launches[leg] = (kmer.pack_on_device.launches
                              - sum(pack_launches.values()))

    build_s = None
    if on_card:
        t0 = time.perf_counter()
        _build.kmer_extract_fn()
        build_s = time.perf_counter() - t0

    genome, reads = workload(args.genome_len, args.coverage)
    n_reads = reads.shape[0]
    n_windows = n_reads * (READ_LEN - k + 1)
    nl = n_limbs(k)
    cfg = AssemblyConfig(k=k, read_len=READ_LEN)

    # reads staged on the device before any count is timed; the transfer
    # is its own number
    packed = pack_codes(reads)
    inv = pack_invalid_mask(reads)
    torch.zeros(8, device=dev).add_(1)
    synchronize(dev)
    t0 = time.perf_counter()
    packed_dev = torch.from_numpy(packed).to(dev)
    inv_dev = None if inv is None else torch.from_numpy(inv).to(dev)
    synchronize(dev)
    transfer_s = time.perf_counter() - t0

    [warmup_s], _ = timed_calls(
        dev, lambda: count_once(packed_dev, k, inv_dev), 1)
    count_s, table = timed_calls(
        dev, lambda: count_once(packed_dev, k, inv_dev), args.reps)
    best = min(count_s)
    kmers_per_s = n_windows / best
    num_unique = int(table.num_unique)
    tally("count")

    # the kernel against its plain version at the bench's shape
    def extract(fn):
        return lambda: fn(packed_dev, READ_LEN, k, inv_bits=inv_dev)

    keys = extract(kmer.extract_canonical_flat_ref)()
    extract_equal = extract_kernel_s = None
    if on_card:
        got = extract(kmer.extract_canonical_flat)()
        extract_equal = torch.equal(got, keys)
        if not extract_equal:
            raise RuntimeError("the extraction kernel != its plain version "
                               "at the bench's shape")
        keys = got
        extract_kernel_s = mean_seconds(
            dev, extract(kmer.extract_canonical_flat), TIMED_CALLS)
    extract_plain_s = mean_seconds(
        dev, extract(kmer.extract_canonical_flat_ref), PLAIN_CALLS)
    bound_ms, bound_by, _ = kmer.kernel_bound_ms(
        n_reads, READ_LEN, k, inv is not None)
    tally("extraction")

    # the stream bandwidth: one elementwise pass over the key stream's size
    big = torch.zeros((n_windows, nl), dtype=torch.int64, device=dev)
    out = torch.empty_like(big)
    stream_s = mean_seconds(dev, lambda: torch.add(big, 1, out=out),
                            TIMED_CALLS)
    measured_bw = 2 * big.numel() * big.element_size() / stream_s
    del big, out

    # the sort floor: sort_by_words's sorts alone, on this key stream
    cols = [keys[:, i].contiguous() for i in range(nl)]
    del keys

    def sorts():
        for col in reversed(cols):
            torch.sort(col, stable=True)

    sort_floor_s = mean_seconds(dev, sorts, TIMED_CALLS)
    del cols

    # the streamed count in bench.py's two-batch plan, against one shot
    # with its host pack and transfer
    stream_cfg = AssemblyConfig(
        k=k, read_len=READ_LEN,
        batch_reads=max(256, -(-n_reads // 512) * 256),
    )
    stream_cap = snug_capacity(num_unique)

    def streamed():
        return count_reads_device(reads, stream_cfg, device=dev,
                                  table_capacity=stream_cap)

    def single_shot():
        p = torch.from_numpy(pack_codes(reads)).to(dev)
        bits = pack_invalid_mask(reads)
        i = None if bits is None else torch.from_numpy(bits).to(dev)
        return count_once(p, k, i)

    streamed()
    times, stream_table = timed_calls(dev, streamed, args.reps)
    stream_count_s = min(times)
    single_shot()
    single_s = min(timed_calls(dev, single_shot, args.reps)[0])
    stream_table_equal = tables_equal(stream_table, table)
    if not stream_table_equal:
        raise RuntimeError("the streamed table != the single-shot table")
    del stream_table
    tally("stream")

    # the reference assembler's counting loop on a subsample
    wpr = READ_LEN - k + 1
    n_base_reads = max(1, args.baseline_windows // wpr)
    t0 = time.perf_counter()
    count_canonical_dict(reads[:n_base_reads], k)
    base_rate = n_base_reads * wpr / (time.perf_counter() - t0)

    # the whole assembly: once cold, then the best of reps warm
    mm_cold = Metrics()
    t0 = time.perf_counter()
    contigs = assemble_torch(reads, cfg, device=dev, metrics=mm_cold)
    asm_cold_s = time.perf_counter() - t0
    asm_s = mm = None
    for _ in range(max(1, args.reps)):
        mm_i = Metrics()
        t0 = time.perf_counter()
        contigs = assemble_torch(reads, cfg, device=dev, metrics=mm_i)
        dt = time.perf_counter() - t0
        if asm_s is None or dt < asm_s:
            asm_s, mm = dt, mm_i
    tally("assemble")
    stats = contig_stats(contigs)

    min_bytes = (packed.nbytes + (0 if inv is None else inv.nbytes)
                 + 2 * n_windows * nl * 8)
    achieved_bw = min_bytes / best
    return {
        "metric": "kmer_count_throughput",
        "value": kmers_per_s,
        "unit": "kmers/s",
        "vs_baseline": kmers_per_s / base_rate,
        "detail": {
            "backend": dev.type,
            "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "card": card,
            "k": k,
            "reads": int(n_reads),
            "windows": int(n_windows),
            "unique_kmers": num_unique,
            "build_s": build_s,
            "best_s": best,
            "count_s": count_s,
            "warmup_s": warmup_s,
            "host_to_device_s": transfer_s,
            "reference_python_kmers_per_s": base_rate,
            "min_traffic_bytes": int(min_bytes),
            "min_traffic_roofline_frac": (
                achieved_bw / HBM_PEAK_BYTES_S if on_card else None),
            "measured_stream_bw_gb_s": measured_bw / 1e9,
            "frac_of_measured_bw": achieved_bw / measured_bw,
            "sort_floor_s": sort_floor_s,
            "sort_ns_per_row": sort_floor_s / n_windows * 1e9,
            "frac_of_sort_floor": sort_floor_s / best,
            "extract_equal": extract_equal,
            "extract_kernel_s": extract_kernel_s,
            "extract_plain_s": extract_plain_s,
            "extract_bound_s": bound_ms / 1e3,
            "extract_bound_by": bound_by,
            "extract_launches": launches,
            "pack_launches": pack_launches,
            "assemble_s": asm_s,
            "assemble_reads_per_s": n_reads / asm_s,
            "assemble_stages_s": dict(mm.stages),
            "assemble_cold_s": asm_cold_s,
            "assemble_cold_stages_s": dict(mm_cold.stages),
            "contigs": stats["contigs"],
            "n50": stats["n50"],
            "exact_match": contigs_equal(contigs, [decode_seq(genome)]),
            "stream_count_s": stream_count_s,
            "single_shot_with_transfer_s": single_s,
            "stream_vs_single_shot": stream_count_s / single_s,
            "stream_table_equal": stream_table_equal,
        },
    }


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # one parseable line, and a failed exit
        traceback.print_exc()
        print(json.dumps({
            "metric": "kmer_count_throughput",
            "value": 0,
            "unit": "kmers/s",
            "vs_baseline": 0,
            "error": f"{type(e).__name__}: {e}",
        }), flush=True)
        sys.exit(1)
