"""Command-line front end of the PyTorch/CUDA port.

    ga-torch assemble --reads reads.txt -k 31 --out contigs.fa
    ga-torch assemble --preset toy10k --coverage 100 -k 25   # simulate + assemble
    ga-torch assemble --reads reads.txt --backend dist --devices 4   # 4 shards
    ga-torch assemble --reads reads.txt --backend dist --sharded-graph
    ga-torch reshard mid.npz --out mid2.npz --devices 2 --reads reads.txt
    python -m genome_assembler_tpu_torch.cli assemble --device cuda ...

``--device`` defaults to ``cuda``; without a CUDA device the command fails
(exit 2) instead of running on the CPU. ``--backend dist`` shards the
count over ``--devices`` shards placed round-robin on the visible GPUs
(``--device cuda``), on one named device (``cuda:N``) or on the CPU
(``cpu``); ``--sharded-graph`` keeps the graph stages sharded as well
instead of gathering the table onto one device. Read parsing, FASTA output and
the read simulator are the reference package's (``genome_assembler_tpu
.cli``, ``utils.io_native``, ``utils.simulate``), which import no JAX.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from genome_assembler_tpu.cli import _add_sim_args, _simulated_reads
from genome_assembler_tpu.cli import read_sequences, write_fasta
from genome_assembler_tpu.utils.config import AssemblyConfig
from genome_assembler_tpu.utils.dna import INVALID_CODE, encode_seq


def _load_reads(path: str) -> np.ndarray:
    """Reads file -> [B, L] uint8 codes; ragged reads pad with
    INVALID_CODE, whose windows are masked like Ns."""
    from genome_assembler_tpu.utils.io_native import load_reads

    native = load_reads(path)  # C++ mmap fast path
    if native is not None:
        return native
    seqs = read_sequences(path)
    if not seqs:
        raise SystemExit(f"no reads found in {path}")
    max_len = max(len(s) for s in seqs)
    reads = np.full((len(seqs), max_len), INVALID_CODE, dtype=np.uint8)
    for i, s in enumerate(seqs):
        reads[i, : len(s)] = encode_seq(s, mask_invalid=True)
    return reads


def _batch(args) -> dict:
    return {"batch_reads": args.batch_reads} if args.batch_reads else {}


def _dist_mesh(args, device):
    """The mesh for --backend dist: --devices shards over every visible
    GPU (``--device cuda``) or over the one named device."""
    from .parallel.mesh import build_mesh

    devices = None if args.device == "cuda" else [device]
    return build_mesh(args.devices, devices=devices)


def cmd_assemble(args) -> int:
    from genome_assembler_tpu.host.traverse import (
        emit_contigs_euler_with_cov,
        emit_contigs_with_cov,
    )
    from genome_assembler_tpu.utils.metrics import Metrics

    from .models.pipeline import assemble_torch
    from .utils.device import resolve_device

    device = resolve_device(args.device)  # fails before any work
    mesh = _dist_mesh(args, device) if args.backend == "dist" else None
    if args.minimizer_len is not None and mesh is None:
        raise ValueError("--minimizer-len needs --backend dist")
    if args.sharded_graph and mesh is None:
        raise ValueError("--sharded-graph needs --backend dist")
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
    )
    if mesh is None:
        _, graph = assemble_torch(reads, cfg, device=device, **common)
        where = f"torch {device}"
    else:
        from .parallel import pipeline as dist

        assemble = (dist.assemble_distributed_sharded if args.sharded_graph
                    else dist.assemble_distributed)
        _, graph = assemble(
            reads, cfg, mesh, minimizer_len=args.minimizer_len, **common
        )
        where = f"dist: {mesh}" + (", sharded graph" if args.sharded_graph
                                   else "")
    with_cov = (
        emit_contigs_euler_with_cov(graph)
        if args.emit == "euler"
        else emit_contigs_with_cov(graph)
    )
    contigs = [s for s, _ in with_cov]
    dt = time.perf_counter() - t0
    if args.metrics_out:
        # stage seconds and counters only: Metrics.derive's roofline share
        # is against a TPU peak, so no derived rates are written
        import json

        report = {
            "device": str(device),
            "stages_s": metrics.stages,
            "counters": metrics.counters,
        }
        if mesh is not None:
            report["shards"] = mesh.size
            report["shard_devices"] = [str(d) for d in mesh.devices]
        with open(args.metrics_out, "w") as fh:
            json.dump(report, fh, indent=2)
            fh.write("\n")
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        write_fasta(contigs, out, coverages=[c for _, c in with_cov])
    finally:
        if args.out:
            out.close()
    total = sum(len(c) for c in contigs)
    print(
        f"assembled {reads.shape[0]} reads -> {len(contigs)} contig(s), "
        f"{total} bp total in {dt:.2f}s [{where}]",
        file=sys.stderr,
    )
    return 0


def cmd_reshard(args) -> int:
    """Rewrite a mid-stream sharded checkpoint for another shard count
    (host-side only: no device work, no recounting)."""
    from .parallel.pipeline import reshard_sharded_stream_checkpoint

    reads = _load_reads(args.reads)
    cfg = AssemblyConfig(k=args.k, read_len=reads.shape[1], **_batch(args))
    reshard_sharded_stream_checkpoint(
        args.infile, args.out, reads.shape, cfg, args.devices,
        table_capacity=args.table_capacity,
    )
    print(f"resharded {args.infile} -> {args.out} for {args.devices} shards",
          file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ga-torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
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
    pa.add_argument("--out", default=None, help="contigs FASTA (default stdout)")
    pa.add_argument("--table-capacity", type=int, default=None,
                    help="unique-k-mer capacity of the streaming count table "
                    "(overflow is a flagged error, never silent)")
    pa.add_argument("--batch-reads", type=int, default=None,
                    help="reads per streamed batch (dist: per global batch, "
                    "split over the shards)")
    pa.add_argument("--checkpoint", default=None,
                    help="save the counted k-mer table (.npz) here")
    pa.add_argument("--resume-from", default=None,
                    help="restart from a checkpoint written by ga-torch or "
                    "ga-tpu: a stage-boundary one skips counting, a "
                    "mid-stream one continues counting from its cursor")
    pa.add_argument("--stream-checkpoint-every", type=int, default=0,
                    help="with --checkpoint: also snapshot the streaming "
                    "counter's table and batch cursor every N batches")
    pa.add_argument("--metrics-out", default=None,
                    help="write per-stage seconds (JSON) here")
    pa.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu; never falls back")
    pa.add_argument("--backend", choices=["torch", "dist"], default="torch",
                    help="torch: one device (default); dist: the count is "
                    "hash-sharded over --devices shards")
    pa.add_argument("--devices", type=int, default=None,
                    help="shard count for --backend dist (default: one per "
                    "visible GPU); a multiple of the device count")
    pa.add_argument("--minimizer-len", type=int, default=None,
                    help="--backend dist: route minimizer super-k-mer "
                    "records instead of per-window keys (try 15 for k=31)")
    pa.add_argument("--sharded-graph", action="store_true",
                    help="keep the graph sharded through compression "
                    "(per-device memory ~1/D; --backend dist, odd k)")
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
    rp.set_defaults(fn=cmd_reshard)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, RuntimeError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
