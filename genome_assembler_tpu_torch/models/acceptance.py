"""Acceptance-config harness (BASELINE.md configs 0-4 and variants 5, 6).

Counterpart of ``genome_assembler_tpu/models/acceptance.py`` with the port
as the backend: one runner a config; each simulates its read set
(synthesized stand-in genomes, the same seeds), runs the port's pipeline,
checks the config's correctness bar and returns the metrics JSON.

  0: error-free 10 kb, 100x, len-100, k=25 -- exact contig match vs oracle.
  1: lambda 48.5 kb, 1% errors, k=31      -- tips + coverage filter.
  2: E. coli 4.6 Mb, 50x, k=31            -- single-device table, roofline.
  3: E. coli, 200x, k in {21,31,41}       -- sort/dedup stress, >64-bit keys.
  4: yeast 12 Mb, 100x, sharded           -- sharded table, all-to-all,
                                             weak-scaling efficiency.
  5: circular E. coli variant of 2        -- origin-wrapping reads, one
                                             closed contig up to rotation.
  6: 16-chromosome yeast variant of 4     -- pooled multi-chromosome
                                             stream, per-chromosome exact
                                             contigs, island handling.

What the reference reads from its environment is a keyword argument of
``run`` and of every runner here: ``scale`` in (0, 1] shrinks genomes and
coverage for tests; ``warm`` makes an untimed first pass;
``force_oracle_check`` runs the dict-oracle cross-check at any scale;
``enforce_weak_scaling`` and ``weak_scaling_min`` set CFG-4's efficiency
bar; ``device`` is where the work runs (``"cuda"`` by default, never a
silent CPU run) and ``devices`` the shard count of configs 4 and 6
(default: one shard a visible GPU, one shard on the CPU).
``multiprocess`` runs every sharded point of configs 4 and 6 as one rank
a shard, each a process (on cards: a card each, NCCL; on the CPU: gloo),
started by ``parallel/launch.py::spawn`` on ``models/acceptance_rank.py``.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..host.dbg import counts_to_dict
from ..host.traverse import (
    contigs_equal,
    expected_contigs_multi,
    kmer_content_equal,
)
from ..parallel.launch import spawn
from ..parallel.mesh import Mesh, build_mesh
from ..parallel.pipeline import (
    assemble_distributed,
    assemble_distributed_sharded,
    distributed_count_table,
)
from ..utils.config import AssemblyConfig
from ..utils.device import resolve_device
from ..utils.dna import decode_seq, revcomp_str
from ..utils.keys import snug_capacity
from ..utils.metrics import Metrics
from ..utils.simulate import (
    simulate_genome,
    simulate_genome_multi,
    simulate_reads,
    simulate_reads_multi,
)
from .oracle import assemble_oracle, count_canonical_fast
from .pipeline import SINGLE_SHOT_WINDOWS, assemble_torch, table_to_host_counts


@dataclass
class AcceptResult:
    config: int
    passed: bool
    detail: dict

    def to_json(self) -> str:
        return json.dumps(
            {"config": self.config, "passed": self.passed, **self.detail}
        )


@dataclass(frozen=True)
class Options:
    """The keyword arguments every runner takes (see the module
    docstring)."""

    scale: float = 1.0
    warm: bool = False
    force_oracle_check: bool = False
    enforce_weak_scaling: bool = False
    weak_scaling_min: float = 0.8
    device: str = "cuda"
    devices: int | None = None
    multiprocess: bool = False

    @property
    def check_oracle(self) -> bool:
        """The dict oracle is minutes to hours at full size; below the
        scale cutoff, or on demand, it cross-checks the contigs."""
        return self.force_oracle_check or self.scale < 0.2

    def shard_count(self) -> int:
        if self.devices is not None:
            return self.devices
        dev = torch.device(self.device)
        if dev.type == "cuda" and dev.index is None:
            resolve_device(dev)  # raises without a card
            return torch.cuda.device_count()
        return 1

    def mesh(self, d: int) -> Mesh:
        """``d`` shards on ``device``: on the named device, or, for plain
        ``"cuda"``, round-robin over the first min(d, visible) GPUs."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and dev.index is None:
            resolve_device(dev)
            n = min(d, torch.cuda.device_count())
            return build_mesh(d, devices=[f"cuda:{i}" for i in range(n)])
        return build_mesh(d, devices=[self.device])


def errored_run_ok(
    contigs: list[str], genome: str, k: int, coverage: float | None = None
) -> bool:
    """Genome-level bar for error-rate configs (CFG 1).

    Strict at every scale: every surviving contig must spell genomic
    sequence exactly (substring of the genome or its reverse complement:
    no chimeras, no residual error bases) and the assembly must be
    near-complete in total bases.

    Contiguity bounds depend on the effective clean-window coverage
    (coverage * 0.99^k for 1% substitutions): at full CFG-1 scale
    (eff >= 40) the bar demands a dominant contig and <= 5 pieces; at
    scaled-down test coverage, occasional zero-clean-coverage breakpoints
    are statistically expected, so only gross shattering fails.
    """
    if not contigs:
        return False
    both = genome + "#" + revcomp_str(genome)
    if any(c not in both for c in contigs):
        return False
    total = sum(len(c) for c in contigs)
    eff = coverage * 0.99**k if coverage is not None else None
    if eff is None or eff >= 40:
        return (
            len(contigs) <= 5
            and total >= 0.95 * len(genome)
            and max(len(c) for c in contigs) >= 0.90 * len(genome)
        )
    return (
        len(contigs) <= 10
        and total >= 0.85 * len(genome)
        and max(len(c) for c in contigs) >= 0.20 * len(genome)
    )


def weak_scaling_efficiency(rates: dict[int, float]) -> dict[int, float]:
    """Efficiency of reads/s rates measured at several shard counts.

    eff(d) = rate(d) / (rate(d0) * d / d0), with d0 the smallest measured
    count: 1.0 means throughput grew linearly with the shards.
    """
    if not rates:
        return {}
    d0 = min(rates.keys())
    base = rates[d0]
    return {d: r / (base * d / d0) for d, r in rates.items()}


def _run_single(
    opt: Options,
    genome_len: int,
    coverage: float,
    k: int,
    *,
    error_rate: float = 0.0,
    min_count: int = 1,
    seed: int = 1000,
    check_oracle: bool = True,
) -> tuple[bool, dict]:
    s = opt.scale
    genome_len = max(int(genome_len * s), 50 * k)
    coverage = max(coverage * max(s, 0.2), 8)
    genome = simulate_genome(genome_len, seed=seed)
    rs = simulate_reads(
        genome,
        coverage=coverage,
        read_len=100,
        seed=seed + 1,
        error_rate=error_rate,
        tile_k=k,
    )
    cfg = AssemblyConfig(k=k, min_count=min_count, read_len=100)
    # Streaming capacity for beyond-single-shot runs: unique k-mers are
    # bounded by the genome plus error-induced novel k-mers.
    total_windows = rs.num_reads * (100 - k + 1)
    if total_windows <= SINGLE_SHOT_WINDOWS:
        capacity = None
    else:
        err_kmers = int(total_windows * min(1.0, error_rate * k) * 1.2)
        # error-free unique canonical k-mers <= genome_len - k + 1 by
        # construction; 1.1x covers simulator edge effects with margin
        # (the snug grid adds its own headroom on top). Every streaming
        # merge sort scales with this capacity, so tight matters
        # (overflow is a flagged error, never silent).
        capacity = snug_capacity(int(1.1 * genome_len) + err_kmers + 4096)
    if opt.warm:
        # untimed first pass: the kernel's build, the allocator's and the
        # pinned slots' first use; the timed run reports steady state
        assemble_torch(rs.codes, cfg, device=opt.device,
                       table_capacity=capacity)
    m = Metrics()
    t0 = time.perf_counter()
    contigs = assemble_torch(
        rs.codes, cfg, device=opt.device, metrics=m, table_capacity=capacity
    )
    wall = time.perf_counter() - t0

    genome_str = decode_seq(genome)
    if error_rate == 0.0:
        passed = contigs_equal(contigs, [genome_str])
        if not passed:
            # repeats > k-1 bases make one-contig reconstruction ambiguous
            # (CFG 3, small k): accept exact k-mer-content equality instead
            passed = kmer_content_equal(contigs, genome_str, k)
    else:
        # Errored reads: end-trimming (coverage dips at genome ends) and
        # rare error-cluster breaks are legitimate, but the result must
        # still be genome-faithful: enforced, not assumed.
        passed = errored_run_ok(contigs, genome_str, k, coverage=coverage)
    if check_oracle:
        oracle = assemble_oracle(rs.codes, cfg)
        passed = passed and contigs == oracle
    detail = {
        "genome_len": genome_len,
        "coverage": round(coverage, 1),
        "k": k,
        "reads": rs.num_reads,
        "contigs": len(contigs),
        "contig_bases": sum(len(c) for c in contigs),
        "wall_s": round(wall, 2),
        "metrics": m.report(),
    }
    return passed, detail


def accept_cfg0(**options) -> AcceptResult:
    opt = Options(**options)
    passed, detail = _run_single(opt, 10_000, 100, 25, seed=1010)
    return AcceptResult(0, passed, detail)


def accept_cfg1(**options) -> AcceptResult:
    opt = Options(**options)
    passed, detail = _run_single(
        opt, 48_502, 100, 31, error_rate=0.01, min_count=5, seed=1020
    )
    return AcceptResult(1, passed, detail)


def accept_cfg2(**options) -> AcceptResult:
    opt = Options(**options)
    passed, detail = _run_single(
        opt, 4_641_652, 50, 31, seed=1030, check_oracle=opt.check_oracle
    )
    return AcceptResult(2, passed, detail)


def accept_cfg3(**options) -> AcceptResult:
    opt = Options(**options)
    details = {}
    ok = True
    for k in (21, 31, 41):
        passed, detail = _run_single(
            opt, 4_641_652, 200, k, seed=1040, check_oracle=opt.check_oracle
        )
        ok = ok and passed
        details[f"k{k}"] = detail
    return AcceptResult(3, ok, details)


def _sharded_counts(reads, cfg, mesh, capacity) -> dict[str, int]:
    """The sharded count as a host dict (the reference's
    ``distributed_count_to_host``): the gathered table, pulled down."""
    table = distributed_count_table(reads, cfg, mesh, table_capacity=capacity)
    return table_to_host_counts(table, cfg.k)


# a rank that hangs in a collective ends a multi-process point after this
RANKS_TIMEOUT_S = 1500.0


class _Ranks:
    """The multi-process points of one config: the reads saved once as a
    ``.npy`` that every rank maps, and ``models/acceptance_rank.py``
    started as ``d`` ranks (a card each on ``"cuda"``) for a job."""

    def __init__(self, opt: Options, reads, cfg, capacity):
        dev = torch.device(opt.device)
        if dev.type == "cuda" and dev.index is not None:
            raise ValueError(
                "multiprocess acceptance takes --device cuda or cpu: every "
                "rank binds a card of its own"
            )
        self.opt, self.cfg, self.capacity = opt, cfg, capacity
        self.tmp = tempfile.TemporaryDirectory()
        self.reads = os.path.join(self.tmp.name, "reads.npy")
        np.save(self.reads, np.ascontiguousarray(reads, dtype=np.uint8))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.tmp.cleanup()
        return False

    def _run(self, job: str, d: int, warm: bool) -> str:
        if self.opt.device == "cuda":
            resolve_device("cuda")
            if d > torch.cuda.device_count():
                raise ValueError(
                    f"multiprocess acceptance on {d} shards needs {d} cards, "
                    f"{torch.cuda.device_count()} visible"
                )
        out = os.path.join(self.tmp.name, f"{job}{d}")
        res = spawn(
            d,
            [job, "--reads", self.reads, "-k", str(self.cfg.k), "--devices",
             str(d), "--capacity", str(self.capacity), "--out", out,
             *(["--warm"] if warm else [])],
            device=self.opt.device, timeout_s=RANKS_TIMEOUT_S,
            entry=("-m", "genome_assembler_tpu_torch.models.acceptance_rank"),
        )
        if not res.ok:
            raise RuntimeError(
                f"multiprocess acceptance, {job} on {d} rank(s): "
                + res.describe()
            )
        return out

    def counts(self, d: int, warm: bool) -> tuple[dict[str, int], float]:
        """({k-mer: count} of the gathered table, the timed count's
        seconds on the slowest rank)."""
        out = self._run("count", d, warm)
        with open(out + ".json") as fh:
            info = json.load(fh)
        if info["overflow"]:
            raise RuntimeError("k-mer table overflow in a multiprocess count")
        with np.load(out + ".table.npz") as z:
            counts = counts_to_dict(z["words"], z["counts"], self.cfg.k)
        return counts, info["seconds"]

    def assemble(self, d: int) -> tuple[list[str], list[str], dict, bool]:
        """(gathered contigs, sharded-graph contigs, the sharded run's
        metrics, every rank returned the same two lists)."""
        out = self._run("assemble", d, False)
        ranks = []
        for r in range(d):
            with open(f"{out}.rank{r}.json") as fh:
                ranks.append(json.load(fh))
        same = all(x["contigs"] == ranks[0]["contigs"]
                   and x["sharded"] == ranks[0]["sharded"] for x in ranks)
        return (ranks[0]["contigs"], ranks[0]["sharded"],
                ranks[0]["metrics"], same)


def accept_cfg4(**options) -> AcceptResult:
    """Sharded counting + both sharded assemblies + weak scaling.

    Bars (each enforced in the runner):
      * sharded counts == host reference counts, bit for bit (the
        vectorized count_canonical_fast, feasible at every size);
      * the distributed assembly is genome-exact, and the gathered and
        fully-sharded graph paths agree; below the scale cutoff (or with
        force_oracle_check) both are also pinned to the dict oracle's
        contigs. Above it the genome bar is the stronger one for
        error-free reads: one exact contig;
      * weak-scaling efficiency at the largest mesh >= weak_scaling_min
        when enforce_weak_scaling (shards on cards of their own only:
        shards that share one device share its throughput, so their
        efficiency is reported but means nothing as a bar).
    """
    opt = Options(**options)
    s = opt.scale
    genome_len = max(int(12_000_000 * s), 2000)
    coverage = max(100 * max(s, 0.2), 8)
    genome = simulate_genome(genome_len, seed=1050)
    rs = simulate_reads(genome, coverage=coverage, read_len=100, seed=1051)
    cfg = AssemblyConfig(k=31, read_len=100)

    # genome-scale unique-k-mer bound: the streamed distributed counter
    # (beyond DIST_STREAM_WINDOWS per shard) sizes its table shards from
    # this instead of the read stream
    capacity = snug_capacity(int(1.5 * genome_len) + 4096)
    n_dev = opt.shard_count()
    sizes = sorted({d for d in (1, 2, n_dev) if d <= n_dev})
    rates: dict[int, float] = {}
    counts_ok = True
    warm = opt.warm or opt.enforce_weak_scaling
    want_counts = count_canonical_fast(rs.codes, cfg.k)
    with (_Ranks(opt, rs.codes, cfg, capacity) if opt.multiprocess
          else contextlib.nullcontext()) as ranks:
        for d in sizes:
            if ranks is not None:
                # the timed count alone, on the slowest rank (the pull into a
                # host dict is the parent's and is not timed)
                counts, dt = ranks.counts(d, warm)
            else:
                mesh = opt.mesh(d)
                if warm:
                    # untimed pass per mesh size: an enforced efficiency bar
                    # must measure steady-state throughput
                    _sharded_counts(rs.codes, cfg, mesh, capacity)
                t0 = time.perf_counter()
                counts = _sharded_counts(rs.codes, cfg, mesh, capacity)
                dt = time.perf_counter() - t0
            rates[d] = rs.num_reads / dt
            counts_ok = counts_ok and counts == want_counts
        eff = weak_scaling_efficiency(rates)

        # Full sharded assembly end to end on the largest mesh: the gathered
        # path and the fully sharded graph path. The genome bar and the
        # cross-path equality always run, at every scale.
        t_asm = time.perf_counter()
        if ranks is not None:
            contigs, sharded, sharded_report, same = ranks.assemble(n_dev)
        else:
            m_sharded = Metrics()
            contigs = assemble_distributed(
                rs.codes, cfg, opt.mesh(n_dev), table_capacity=capacity
            )
            sharded = assemble_distributed_sharded(
                rs.codes, cfg, opt.mesh(n_dev), table_capacity=capacity,
                metrics=m_sharded,
            )
            sharded_report, same = m_sharded.report(), True
    asm_wall = time.perf_counter() - t_asm
    assembly_ok = same and sharded == contigs and contigs_equal(
        contigs, [decode_seq(genome)]
    )
    if opt.check_oracle:
        oracle = assemble_oracle(rs.codes, cfg)
        assembly_ok = assembly_ok and contigs == oracle

    passed = counts_ok and assembly_ok
    eff_bar = None
    if opt.enforce_weak_scaling:
        eff_bar = opt.weak_scaling_min
        passed = passed and eff[max(rates.keys())] >= eff_bar
    return AcceptResult(
        4,
        passed,
        {
            "genome_len": genome_len,
            "reads": rs.num_reads,
            "scale": s,
            "date": datetime.date.today().isoformat(),
            "devices": sizes,
            "counts_match_host": counts_ok,
            "assembly_genome_exact_and_paths_agree": assembly_ok,
            "oracle_cross_checked": opt.check_oracle,
            "assembly_wall_s": round(asm_wall, 1),
            "contigs": len(contigs),
            "reads_per_s": {str(d): round(r, 1) for d, r in rates.items()},
            "weak_scaling_eff": {str(d): round(e, 3) for d, e in eff.items()},
            "weak_scaling_bar": eff_bar,
            # beside the reference's keys only when it is on
            **({"multiprocess": True} if opt.multiprocess else {}),
            "unique_kmers": len(counts),
            # wire/link volume of the sharded run
            "sharded_run_metrics": sharded_report,
        },
    )


def accept_cfg5(**options) -> AcceptResult:
    """Circular-genome CFG-2 variant.

    Reads wrap across the origin, the de Bruijn graph closes into one
    cycle, and the bar is the circular round-trip: exactly one contig
    equal to the genome at the least rotation over both strands
    (expected_contigs_multi). Oracle cross-check below the scale cutoff
    or on demand, as CFG-2.
    """
    opt = Options(**options)
    s = opt.scale
    genome_len = max(int(4_641_652 * s), 2000)
    coverage = max(50 * max(s, 0.2), 8)
    genome = simulate_genome(genome_len, seed=1060)
    rs = simulate_reads(
        genome, coverage=coverage, read_len=100, seed=1061, tile_k=31,
        circular=True,
    )
    cfg = AssemblyConfig(k=31, read_len=100)
    total_windows = rs.num_reads * (100 - 31 + 1)
    capacity = (
        None if total_windows <= SINGLE_SHOT_WINDOWS
        else snug_capacity(int(1.1 * genome_len) + 4096)
    )
    if opt.warm:
        assemble_torch(rs.codes, cfg, device=opt.device,
                       table_capacity=capacity)
    m = Metrics()
    t0 = time.perf_counter()
    contigs = assemble_torch(rs.codes, cfg, device=opt.device, metrics=m,
                             table_capacity=capacity)
    wall = time.perf_counter() - t0
    want = expected_contigs_multi([decode_seq(genome)], 31, circular=True)
    passed = contigs_equal(contigs, want)
    if opt.check_oracle:
        oracle = assemble_oracle(rs.codes, cfg)
        passed = passed and contigs == oracle
    return AcceptResult(
        5,
        passed,
        {
            "variant": "cfg2_circular",
            "genome_len": genome_len,
            "coverage": round(coverage, 1),
            "reads": rs.num_reads,
            "contigs": len(contigs),
            "contig_bases": sum(len(c) for c in contigs),
            "rotation_exact": passed,
            "wall_s": round(wall, 2),
            "metrics": m.report(),
        },
    )


def _yeast_chromosome_lengths(total: int, n: int = 16) -> list[int]:
    """Deterministic yeast-like chromosome size spread summing to
    ``total``: real S. cerevisiae chromosomes span ~230 kb to ~1.5 Mb
    (a ~6.5x spread); a fixed geometric-ish ramp reproduces that shape
    at any acceptance scale."""
    w = [1.0 + 5.5 * i / (n - 1) for i in range(n)]
    sw = sum(w)
    lens = [max(int(total * wi / sw), 200) for wi in w]
    lens[-1] += total - sum(lens)  # exact total
    return lens


def accept_cfg6(**options) -> AcceptResult:
    """Multi-chromosome CFG-4 variant: 16-chromosome yeast-like 12 Mb.

    Reads from all chromosomes pool into one shuffled stream; the
    distributed gathered and fully-sharded graph paths must agree, the
    sharded counts must equal the host reference bit for bit, and the
    contig set must be per-chromosome exact (each chromosome one
    contig, expected_contigs_multi).
    """
    opt = Options(**options)
    s = opt.scale
    total = max(int(12_000_000 * s), 32_000)
    coverage = max(100 * max(s, 0.2), 8)
    lens = _yeast_chromosome_lengths(total)
    genomes = simulate_genome_multi(lens, seed=1070)
    rs = simulate_reads_multi(
        genomes, coverage=coverage, read_len=100, seed=1071, tile_k=31
    )
    cfg = AssemblyConfig(k=31, read_len=100)
    capacity = snug_capacity(int(1.5 * total) + 4096)
    n_dev = opt.shard_count()
    if opt.multiprocess:
        with _Ranks(opt, rs.codes, cfg, capacity) as ranks:
            counts, _ = ranks.counts(n_dev, False)
            t0 = time.perf_counter()
            contigs, sharded, sharded_report, same = ranks.assemble(n_dev)
    else:
        mesh = opt.mesh(n_dev)
        counts = _sharded_counts(rs.codes, cfg, mesh, capacity)
        m_sharded = Metrics()
        t0 = time.perf_counter()
        contigs = assemble_distributed(
            rs.codes, cfg, mesh, table_capacity=capacity
        )
        sharded = assemble_distributed_sharded(
            rs.codes, cfg, mesh, table_capacity=capacity, metrics=m_sharded
        )
        sharded_report, same = m_sharded.report(), True
    wall = time.perf_counter() - t0
    counts_ok = counts == count_canonical_fast(rs.codes, cfg.k)
    want = expected_contigs_multi([decode_seq(g) for g in genomes], 31)
    per_chrom = contigs_equal(contigs, want)
    paths_agree = same and sharded == contigs
    passed = counts_ok and per_chrom and paths_agree
    if opt.check_oracle:
        oracle = assemble_oracle(rs.codes, cfg)
        passed = passed and contigs == oracle
    return AcceptResult(
        6,
        passed,
        {
            "variant": "cfg4_multichromosome",
            "chromosomes": len(lens),
            "chromosome_lens": lens,
            "total_len": total,
            "coverage": round(coverage, 1),
            "reads": rs.num_reads,
            "scale": s,
            "date": datetime.date.today().isoformat(),
            "devices": n_dev,
            "counts_match_host": counts_ok,
            "per_chromosome_exact": per_chrom,
            "paths_agree": paths_agree,
            "contigs": len(contigs),
            "assembly_wall_s": round(wall, 1),
            # beside the reference's keys only when it is on
            **({"multiprocess": True} if opt.multiprocess else {}),
            "sharded_run_metrics": sharded_report,
        },
    )


RUNNERS: dict[int, Callable[..., AcceptResult]] = {
    0: accept_cfg0,
    1: accept_cfg1,
    2: accept_cfg2,
    3: accept_cfg3,
    4: accept_cfg4,
    5: accept_cfg5,
    6: accept_cfg6,
}


def run(
    config_ids: list[int],
    on_result: Callable[[AcceptResult], None] | None = None,
    **options,
) -> list[AcceptResult]:
    """Run the configs in order; ``options`` are ``Options``' fields
    (scale, warm, force_oracle_check, enforce_weak_scaling,
    weak_scaling_min, device, devices, multiprocess)."""
    resolve_device(Options(**options).device)  # fails before any work
    results = []
    for cid in config_ids:
        r = RUNNERS[cid](**options)
        if on_result is not None:
            on_result(r)  # stream results: configs can run for minutes
        results.append(r)
    return results
