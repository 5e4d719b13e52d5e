"""Command-line front end of the PyTorch/CUDA port.

    ga-torch simulate --preset lambda --coverage 100 --out reads.txt
    ga-torch assemble --reads reads.txt -k 31 --out contigs.fa
    ga-torch assemble --preset toy10k --coverage 100 -k 25   # simulate + assemble
    ga-torch assemble --reads reads.txt --backend oracle     # host oracle, no device
    ga-torch assemble --reads reads.txt --backend dist --devices 4   # 4 shards
    ga-torch assemble --reads reads.txt --backend dist --sharded-graph
    ga-torch assemble --reads reads.txt --gfa g.gfa --stats --trace-dir trace/
    torchrun --nproc-per-node 4 -m genome_assembler_tpu_torch.cli assemble \
        --reads reads.txt --backend dist --devices 4 --hosts 4   # a rank a card
    ga-torch assemble --reads reads.txt --table-capacity 20000000 --bucketed on
    ga-torch assemble --reads reads.txt --table-capacity 20000000 --merge-stride 4
    ga-torch reshard mid.npz --out mid2.npz --devices 2 --reads reads.txt
    ga-torch stats contigs.fa
    ga-torch accept 0 1 2 --device cuda
    ga-torch accept 4 --multiprocess --enforce-weak-scaling
    ga-torch verify-reference /path/to/reference
    python -m genome_assembler_tpu_torch.cli assemble --device cuda ...

``--device`` defaults to ``cuda``; without a CUDA device the command fails
(exit 2) instead of running on the CPU. ``--backend dist`` shards the
count over ``--devices`` shards placed round-robin on the visible GPUs
(``--device cuda``), on one named device (``cuda:N``) or on the CPU
(``cpu``); ``--sharded-graph`` keeps the graph stages sharded as well
instead of gathering the table onto one device. Started as several
processes with torch's launch variables (``torchrun``, or
``parallel/launch.py::spawn``), ``--backend dist`` runs one rank a process
over a ``torch.distributed`` group (NCCL on cards, gloo with ``--device
cpu``): every rank runs the identical command on the same reads file and
owns ``--devices / --hosts`` shards. ``--bucketed`` picks the streaming
count table's layout (hash buckets merged a few batches at a time, or one
flat table; ``auto`` takes the buckets once one merge passes 25 x 2^20
rows, as ``ga-tpu`` does); ``--merge-stride N`` lets the raw keys of N
batches wait on the device and merges them at once (the layout rule then
counts N batches' rows); the counts are the same either way.
``--trace-dir`` wraps the
run in ``torch.profiler`` and leaves a Chrome trace there, every stage a
named span. Read parsing, FASTA output and
the read simulator are the port's own copies of the reference package's
(``read_sequences``, ``write_fasta``, ``utils.io_native``,
``utils.simulate``).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .utils.config import AssemblyConfig
from .utils.dna import INVALID_CODE, decode_seq, encode_seq
from .utils.simulate import GENOME_PRESETS, preset_genome, simulate_genome, simulate_reads


def read_sequences(path: str) -> list[str]:
    """Load reads: FASTA if the first record starts with '>', FASTQ if it
    starts with '@' (sequence lines kept, quality lines skipped), else one
    sequence per line (multi-line joining only applies to FASTA records).
    path '-' reads stdin (reference CLI parity: assemble < reads)."""
    if path == "-":
        lines = [ln.strip() for ln in sys.stdin]
    else:
        with open(path) as fh:
            lines = [ln.strip() for ln in fh]
    lines = [ln for ln in lines if ln]
    if not lines:
        return []
    if lines[0].startswith("@"):
        # FASTQ: 4-line records (@header, sequence, +separator, quality)
        if len(lines) % 4 != 0:
            raise ValueError(
                f"{path}: malformed FASTQ ({len(lines)} non-empty lines, "
                "expected a multiple of 4)"
            )
        return [lines[i + 1].upper() for i in range(0, len(lines), 4)]
    if not lines[0].startswith(">"):
        return [ln.upper() for ln in lines]
    seqs: list[str] = []
    current: list[str] = []
    for line in lines:
        if line.startswith(">"):
            if current:
                seqs.append("".join(current))
                current = []
        else:
            current.append(line.upper())
    if current:
        seqs.append("".join(current))
    return seqs


def write_fasta(
    contigs: list[str],
    fh,
    prefix: str = "contig",
    coverages: list[float] | None = None,
) -> None:
    for i, seq in enumerate(contigs):
        cov = f" cov={coverages[i]:.1f}" if coverages else ""
        fh.write(f">{prefix}_{i} len={len(seq)}{cov}\n")
        for j in range(0, len(seq), 80):
            fh.write(seq[j : j + 80] + "\n")


def _add_sim_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", choices=sorted(GENOME_PRESETS), default=None,
                   help="synthesized stand-in genome (BASELINE.md configs)")
    p.add_argument("--genome-len", type=int, default=None,
                   help="random genome length (alternative to --preset)")
    p.add_argument("--genome-seed", type=int, default=101)
    p.add_argument("--coverage", type=float, default=100.0)
    p.add_argument("--read-len", type=int, default=100)
    p.add_argument("--error-rate", type=float, default=0.0)
    p.add_argument("--read-seed", type=int, default=1)
    p.add_argument("--single-strand", action="store_true",
                   help="forward-strand reads only")
    p.add_argument("--chromosomes", type=int, default=1,
                   help="split --genome-len across N independent "
                   "chromosomes (multi-contig ground truth)")
    p.add_argument("--circular", action="store_true",
                   help="circular chromosome(s): reads wrap the origin")


def _simulated_reads(args) -> tuple[np.ndarray, list[np.ndarray]]:
    n_chrom = getattr(args, "chromosomes", 1)
    circular = getattr(args, "circular", False)
    if args.preset:
        genomes = [preset_genome(args.preset)]
    elif args.genome_len:
        if n_chrom > 1:
            from .utils.simulate import simulate_genome_multi

            per = args.genome_len // n_chrom
            lens = [per] * (n_chrom - 1) + [args.genome_len - per * (n_chrom - 1)]
            genomes = simulate_genome_multi(lens, seed=args.genome_seed)
        else:
            genomes = [simulate_genome(args.genome_len, seed=args.genome_seed)]
    else:
        raise SystemExit("need --preset or --genome-len (or --reads)")
    if len(genomes) > 1:
        from .utils.simulate import simulate_reads_multi

        rs = simulate_reads_multi(
            genomes,
            coverage=args.coverage,
            read_len=args.read_len,
            seed=args.read_seed,
            error_rate=args.error_rate,
            circular=circular,
        )
    else:
        rs = simulate_reads(
            genomes[0],
            coverage=args.coverage,
            read_len=args.read_len,
            seed=args.read_seed,
            error_rate=args.error_rate,
            both_strands=not args.single_strand,
            circular=circular,
        )
    return rs.codes, genomes


def cmd_simulate(args) -> int:
    codes, genomes = _simulated_reads(args)
    out = open(args.out, "w") if args.out else sys.stdout
    for row in codes:
        out.write(decode_seq(row) + "\n")
    if args.out:
        out.close()
    if args.genome_out:
        with open(args.genome_out, "w") as fh:
            write_fasta([decode_seq(g) for g in genomes], fh, prefix="genome")
    total = sum(len(g) for g in genomes)
    chrom = f" in {len(genomes)} chromosomes" if len(genomes) > 1 else ""
    print(
        f"simulated {len(codes)} reads x {codes.shape[1]} bp"
        f" (genome {total} bp{chrom})",
        file=sys.stderr,
    )
    return 0


def _load_reads(path: str, ragged_ok: bool = False) -> np.ndarray | list[str]:
    """Reads file -> [B, L] uint8 codes; ragged reads pad with
    INVALID_CODE, whose windows are masked like Ns, or, with
    ``ragged_ok`` (the oracle's dict counting path), stay strings."""
    from .utils.io_native import load_reads

    native = load_reads(path)  # C++ mmap fast path
    if native is not None:
        return native
    seqs = read_sequences(path)
    if not seqs:
        raise SystemExit(f"no reads found in {path}")
    if ragged_ok and len({len(s) for s in seqs}) > 1:
        return seqs
    max_len = max(len(s) for s in seqs)
    reads = np.full((len(seqs), max_len), INVALID_CODE, dtype=np.uint8)
    for i, s in enumerate(seqs):
        reads[i, : len(s)] = encode_seq(s, mask_invalid=True)
    return reads


def _batch(args) -> dict:
    return {"batch_reads": args.batch_reads} if args.batch_reads else {}


def _dist_mesh(args, device):
    """The mesh for --backend dist: --devices shards over every visible
    GPU (``--device cuda``) or over the one named device. Under torch's
    launch variables the process group is made first (NCCL, or gloo for
    ``--device cpu``), ``--hosts`` defaults to its size, and ``--device
    cuda`` is the rank's own card."""
    from .parallel.mesh import build_mesh, init_distributed

    init_distributed("gloo" if device.type == "cpu" else "nccl")
    devices = None if args.device == "cuda" else [device]
    return build_mesh(args.devices, devices=devices, hosts=args.hosts)


def _rank_path(path: str | None, rank: int) -> str | None:
    """An output path of rank ``rank`` of a multi-process run: rank 0
    keeps the path, rank r > 0 appends ``.rank<r>``."""
    return path if not path or rank == 0 else f"{path}.rank{rank}"


def _graph_outputs(args, graph) -> tuple[list[str], list[float]]:
    """The outputs every graph-producing backend shares: the optional GFA
    1.0 export, and (contigs, per-contig mean k-mer coverage) from one
    traversal."""
    if args.gfa:
        from .host.stats import write_gfa

        with open(args.gfa, "w") as fh:
            write_gfa(graph, fh)
    from .host.traverse import (
        emit_contigs_euler_with_cov,
        emit_contigs_with_cov,
    )

    with_cov = (
        emit_contigs_euler_with_cov(graph)
        if args.emit == "euler"
        else emit_contigs_with_cov(graph)
    )
    return [s for s, _ in with_cov], [c for _, c in with_cov]


def _write_contigs(args, contigs, coverages, n_reads, dt, where) -> None:
    if args.stats:
        from .host.stats import stats_json

        print(stats_json(contigs), file=sys.stderr)
    if args.out:
        with open(args.out, "w") as out:
            write_fasta(contigs, out, coverages=coverages)
    elif getattr(args, "rank", 0) == 0:
        write_fasta(contigs, sys.stdout, coverages=coverages)
    total = sum(len(c) for c in contigs)
    print(
        f"assembled {n_reads} reads -> {len(contigs)} contig(s), "
        f"{total} bp total in {dt:.2f}s [{where}]",
        file=sys.stderr,
    )


def _assemble_oracle(args) -> int:
    """--backend oracle: the NumPy/dict oracle on the host; no device is
    touched, and ragged reads take its dict counting path."""
    from .models.oracle import assemble_oracle

    t0 = time.perf_counter()
    reads = (_load_reads(args.reads, ragged_ok=True) if args.reads
             else _simulated_reads(args)[0])
    cfg = AssemblyConfig(
        k=args.k,
        min_count=args.min_count,
        tip_len=args.tip_len,
        bubble_len=args.bubble_len,
        read_len=(reads.shape[1] if isinstance(reads, np.ndarray)
                  else args.read_len),
        **_batch(args),
    )
    contigs = assemble_oracle(reads, cfg, emit=args.emit)
    _write_contigs(args, contigs, None, len(reads),
                   time.perf_counter() - t0, "oracle")
    return 0


def cmd_assemble(args) -> int:
    from .utils.metrics import Metrics, profiler_trace

    from .models.pipeline import assemble_torch
    from .utils.device import resolve_device

    if args.merge_stride is not None and args.merge_stride < 1:
        raise SystemExit("--merge-stride must be >= 1")
    if args.backend == "oracle":
        return _assemble_oracle(args)
    device = resolve_device(args.device)  # fails before any work
    mesh = _dist_mesh(args, device) if args.backend == "dist" else None
    if args.minimizer_len is not None and mesh is None:
        raise ValueError("--minimizer-len needs --backend dist")
    if args.sharded_graph and mesh is None:
        raise ValueError("--sharded-graph needs --backend dist")
    if args.hosts is not None and mesh is None:
        raise ValueError("--hosts needs --backend dist")
    if mesh is not None and mesh.distributed:
        # every rank runs the whole command; rank 0 keeps the paths as
        # given, the others write beside them (see the flags' help)
        args.rank = mesh.rank
        device = mesh.devices[0]
        for name in ("out", "metrics_out", "trace_dir"):
            setattr(args, name, _rank_path(getattr(args, name), mesh.rank))
        if mesh.rank:
            args.gfa = None
        if args.reads:
            # one rank builds the native loader, the others find it built
            from .parallel.mesh import barrier
            from .utils import io_native

            if mesh.rank == 0:
                io_native.available()
            barrier(mesh)
    t0 = time.perf_counter()
    reads = _load_reads(args.reads) if args.reads else _simulated_reads(args)[0]
    cfg = AssemblyConfig(
        k=args.k,
        min_count=args.min_count,
        tip_len=args.tip_len,
        bubble_len=args.bubble_len,
        read_len=reads.shape[1],
        **_batch(args),
    )
    metrics = Metrics()
    common = dict(
        metrics=metrics,
        checkpoint=args.checkpoint,
        resume_from=args.resume_from,
        return_graph=True,
        emit=args.emit,
        table_capacity=args.table_capacity,
        stream_checkpoint_every=args.stream_checkpoint_every,
        bucketed=args.bucketed,
        merge_stride=args.merge_stride,
    )
    with profiler_trace(args.trace_dir):
        if mesh is None:
            _, graph = assemble_torch(reads, cfg, device=device, **common)
            where = f"torch {device}"
        else:
            from .parallel import pipeline as dist

            assemble = (dist.assemble_distributed_sharded
                        if args.sharded_graph else dist.assemble_distributed)
            _, graph = assemble(
                reads, cfg, mesh, minimizer_len=args.minimizer_len, **common
            )
            where = f"dist: {mesh}" + (", sharded graph" if args.sharded_graph
                                       else "")
    stride = None
    if "count" in metrics.stages:  # the reads were counted: the stride taken
        stride = int(metrics.counters.get("merge_stride", 1))
        where += f", merge stride {stride}"
    contigs, coverages = _graph_outputs(args, graph)
    dt = time.perf_counter() - t0
    if args.metrics_out:
        # Metrics.report(): the reference's (stages_s, counters, derived)
        # and the host spans inside the stages (spans_s), and beside it
        # where the run was placed
        import json

        from .ops.kmer_torch import extract_canonical_flat, pack_on_device

        report = dict(metrics.report(), device=str(device), wall_s=dt,
                      kernel_launches=extract_canonical_flat.launches,
                      pack_launches=pack_on_device.launches,
                      merge_stride=stride)
        if device.type == "cuda":
            import torch

            report["peak_device_bytes"] = torch.cuda.max_memory_allocated(
                device)
        if mesh is not None:
            report["shards"] = mesh.size
            report["shard_devices"] = [str(d) for d in mesh.devices]
            report["hosts"] = mesh.hosts
            report["rank"] = mesh.rank
            report["local_shards"] = list(mesh.local_shards)
        with open(args.metrics_out, "w") as fh:
            json.dump(report, fh, indent=2)
            fh.write("\n")
    _write_contigs(args, contigs, coverages, reads.shape[0], dt, where)
    if mesh is not None and mesh.distributed:
        # only a run that reached its end leaves the group: a failed rank's
        # peers may be inside a collective, and the launcher ends them
        from .parallel.mesh import shutdown_distributed

        shutdown_distributed()
    return 0


def cmd_reshard(args) -> int:
    """Rewrite a mid-stream sharded checkpoint for another shard count
    (host-side only: no device work, no recounting)."""
    from .parallel.pipeline import reshard_sharded_stream_checkpoint

    reads = _load_reads(args.reads)
    cfg = AssemblyConfig(k=args.k, read_len=reads.shape[1], **_batch(args))
    if args.merge_stride is not None and args.merge_stride < 1:
        raise SystemExit("--merge-stride must be >= 1")
    reshard_sharded_stream_checkpoint(
        args.infile, args.out, reads.shape, cfg, args.devices,
        table_capacity=args.table_capacity, bucketed=args.bucketed,
        merge_stride=args.merge_stride,
    )
    print(f"resharded {args.infile} -> {args.out} for {args.devices} shards",
          file=sys.stderr)
    return 0


def cmd_stats(args) -> int:
    """Contig statistics of an existing FASTA or lines file, as one JSON
    line (no assembly is run)."""
    from .host.stats import stats_json

    print(stats_json(read_sequences(args.contigs)))
    return 0


def cmd_accept(args) -> int:
    """Run acceptance configs; one JSON line a config as it finishes;
    exit 1 if any fails."""
    from .models.acceptance import RUNNERS, run

    ids = args.configs if args.configs else sorted(RUNNERS)

    def emit(r):
        print(r.to_json(), flush=True)

    results = run(
        ids, on_result=emit, scale=args.scale, warm=args.warm,
        force_oracle_check=args.force_oracle_check, device=args.device,
        devices=args.devices,
        enforce_weak_scaling=args.enforce_weak_scaling,
        weak_scaling_min=args.weak_scaling_min,
        multiprocess=args.multiprocess,
    )
    return 0 if all(r.passed for r in results) else 1


def _cmd_verify_reference(args) -> int:
    from .verify_reference import cmd_verify_reference

    return cmd_verify_reference(args)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ga-torch", description=__doc__)
    p.add_argument("-v", "--verbose", action="store_true",
                   help="debug logging (per-stage timings)")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("simulate", help="simulate reads from a genome")
    _add_sim_args(ps)
    ps.add_argument("--out", default=None, help="reads output (default stdout)")
    ps.add_argument("--genome-out", default=None, help="write genome FASTA")
    ps.set_defaults(fn=cmd_simulate)

    pa = sub.add_parser("assemble", help="assemble reads into contigs")
    pa.add_argument("--reads", default=None,
                    help="reads file (lines, FASTA or FASTQ)")
    _add_sim_args(pa)
    pa.add_argument("-k", type=int, default=31)
    pa.add_argument("--min-count", type=int, default=1,
                    help="coverage filter; 0 picks it from the histogram")
    pa.add_argument("--tip-len", type=int, default=None)
    pa.add_argument("--bubble-len", type=int, default=None)
    pa.add_argument("--emit", choices=["unitigs", "euler"], default="unitigs",
                    help="unitigs stop at junctions (default); euler spells "
                    "Eulerian walks")
    pa.add_argument("--out", default=None,
                    help="contigs FASTA (default stdout); in a multi-process "
                    "run every rank writes the same contigs, rank r > 0 to "
                    "OUT.rank<r> (only rank 0 writes to stdout)")
    pa.add_argument("--table-capacity", type=int, default=None,
                    help="unique-k-mer capacity of the streaming count table "
                    "(overflow is a flagged error, never silent)")
    pa.add_argument("--batch-reads", type=int, default=None,
                    help="reads per streamed batch (dist: per global batch, "
                    "split over the shards)")
    pa.add_argument("--checkpoint", default=None,
                    help="save the counted k-mer table (.npz) here (in a "
                    "multi-process run rank 0 writes the one file of all "
                    "shards)")
    pa.add_argument("--resume-from", default=None,
                    help="restart from a checkpoint written by ga-torch or "
                    "ga-tpu: a stage-boundary one skips counting, a "
                    "mid-stream one continues counting from its cursor")
    pa.add_argument("--stream-checkpoint-every", type=int, default=0,
                    help="with --checkpoint: also snapshot the streaming "
                    "counter's table and batch cursor every N batches")
    pa.add_argument("--metrics-out", default=None,
                    help="write the per-stage metrics JSON here (stages_s, "
                    "counters, derived rates, spans_s with the host's "
                    "work inside the stages, the extraction kernel's "
                    "launches; torch and dist backends; in a multi-process "
                    "run rank r > 0 writes PATH.rank<r>)")
    pa.add_argument("--stats", action="store_true",
                    help="print contig summary stats (N50 etc.) to stderr")
    pa.add_argument("--gfa", default=None,
                    help="write the simplified unitig graph as GFA 1.0 "
                    "(torch and dist backends; in a multi-process run rank "
                    "0 writes it)")
    pa.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler Chrome trace of the run "
                    "here (torch and dist backends; in a multi-process run "
                    "rank r > 0 writes DIR.rank<r>)")
    pa.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu; never falls back")
    pa.add_argument("--backend", choices=["torch", "dist", "oracle"],
                    default="torch",
                    help="torch: one device (default); dist: the count is "
                    "hash-sharded over --devices shards; oracle: the "
                    "NumPy/dict oracle on the host (no device)")
    pa.add_argument("--devices", type=int, default=None,
                    help="shard count for --backend dist (default: one per "
                    "visible GPU); a multiple of the device count; in a "
                    "multi-process run the global count over all ranks")
    pa.add_argument("--hosts", type=int, default=None,
                    help="build a 2-level (host, chip) mesh with this many "
                    "hosts (--backend dist; a multi-process run, started "
                    "by torchrun or parallel/launch.py, has one host a "
                    "process and this defaults to their number)")
    pa.add_argument("--minimizer-len", type=int, default=None,
                    help="--backend dist: route minimizer super-k-mer "
                    "records instead of per-window keys (try 15 for k=31)")
    pa.add_argument("--sharded-graph", action="store_true",
                    help="keep the graph sharded through compression "
                    "(per-device memory ~1/D; --backend dist, odd k)")
    pa.add_argument("--bucketed", choices=["auto", "on", "off"],
                    default="auto",
                    help="the streaming count table's layout: hash buckets "
                    "(on), one flat table (off), or buckets once one merge "
                    "passes 25 x 2^20 rows (auto, the default; torch and "
                    "dist backends; every shard's table with dist)")
    pa.add_argument("--merge-stride", type=int, default=None,
                    help="deferred merges: the streaming count's raw keys "
                    "of this many batches wait on the device and merge "
                    "into the table at once (torch and dist backends; "
                    "default 1, a merge every batch; the same table at "
                    "any stride; --metrics-out and stderr name the stride "
                    "taken)")
    pa.set_defaults(fn=cmd_assemble)

    rp = sub.add_parser(
        "reshard", aliases=["reshard-checkpoint"],
        help="rewrite a mid-stream sharded checkpoint for another shard "
        "count (resume a stopped distributed count on fewer or more shards)",
    )
    rp.add_argument("infile", help="mid-stream sharded checkpoint (.npz)")
    rp.add_argument("--out", required=True, help="rewritten checkpoint")
    rp.add_argument("--devices", type=int, required=True,
                    help="shard count the resumed run will use")
    rp.add_argument("--reads", required=True,
                    help="the original reads file (its shape must match)")
    rp.add_argument("-k", type=int, default=31)
    rp.add_argument("--batch-reads", type=int, default=None)
    rp.add_argument("--table-capacity", type=int, default=None)
    rp.add_argument("--bucketed", choices=["auto", "on", "off"],
                    default="auto",
                    help="the layout the resumed run will take (its "
                    "--bucketed); the input may be in either")
    rp.add_argument("--merge-stride", type=int, default=None,
                    help="the merge stride the resumed run will take (its "
                    "--merge-stride)")
    rp.set_defaults(fn=cmd_reshard)

    pst = sub.add_parser(
        "stats",
        help="contig statistics (count/bases/N50/longest) of a FASTA or "
        "line file, as one JSON line",
    )
    pst.add_argument("contigs", help="contigs file (FASTA or plain lines)")
    pst.set_defaults(fn=cmd_stats)

    pc = sub.add_parser(
        "accept", help="run acceptance configs (0-4, 5: circular, 6: "
        "multi-chromosome) and print one JSON line each",
    )
    pc.add_argument("configs", nargs="*", type=int, default=None,
                    help="config ids (default: all)")
    pc.add_argument("--scale", type=float, default=1.0,
                    help="shrink genomes and coverage, in (0, 1]")
    pc.add_argument("--warm", action="store_true",
                    help="an untimed first pass before each timed run")
    pc.add_argument("--force-oracle-check", action="store_true",
                    help="cross-check against the dict oracle at any scale")
    pc.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu; never falls back")
    pc.add_argument("--devices", type=int, default=None,
                    help="shard count of configs 4 and 6 (default: one per "
                    "visible GPU)")
    pc.add_argument("--enforce-weak-scaling", action="store_true",
                    help="config 4: fail unless the weak-scaling efficiency "
                    "at the largest mesh reaches --weak-scaling-min (an "
                    "untimed pass a mesh size comes first)")
    pc.add_argument("--weak-scaling-min", type=float, default=0.8,
                    help="the efficiency bar of --enforce-weak-scaling "
                    "(default 0.8)")
    pc.add_argument("--multiprocess", action="store_true",
                    help="configs 4 and 6: run every sharded point as one "
                    "rank a shard (a process and, on cards, a card each) "
                    "through parallel/launch.py")
    pc.set_defaults(fn=cmd_accept)

    pv = sub.add_parser(
        "verify-reference",
        help="run the upstream reference assembler and diff contigs",
    )
    pv.add_argument("path", help="reference checkout")
    pv.add_argument("--reads", default=None,
                    help="reads file to feed both assemblers "
                    "(default: simulate CFG 0)")
    pv.add_argument("--cmd", default=None,
                    help="shell template to run the reference, with {entry} "
                    "and {reads} placeholders")
    pv.add_argument("-k", type=int, default=25,
                    help="k tried first in the sweep")
    pv.add_argument("--ks", default=None,
                    help="comma-separated k sweep (default: k,25,31,21)")
    pv.add_argument("--emits", default=None,
                    help="comma-separated emission modes to sweep "
                    "(default: unitigs,euler)")
    pv.add_argument("--min-count", type=int, default=1)
    pv.add_argument("--use-ref-data", action="store_true",
                    help="run on the reference's bundled read sets")
    pv.add_argument("--device", default="cuda",
                    help="device of the torch backend: cuda (default), "
                    "cuda:N or cpu")
    pv.set_defaults(fn=_cmd_verify_reference)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.verbose:
        import logging

        logging.basicConfig(
            level=logging.DEBUG,
            format="%(asctime)s %(name)s %(levelname)s %(message)s",
        )
    try:
        return args.fn(args)
    except (ValueError, RuntimeError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
