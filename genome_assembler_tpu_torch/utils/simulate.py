"""Seeded genome + read simulator (SURVEY.md §6).

No genome data ships in this environment, so the acceptance configs
(BASELINE.md: lambda phage 48.5 kb, E. coli 4.6 Mb, yeast 12 Mb) run on
synthesized genomes with matching sizes and statistics, generated from fixed
seeds so every run and every device sees identical inputs. The simulator is a
first-class component: every test, acceptance config, and benchmark draws its
reads from here.

Outputs are fixed-width ``[B, L]`` uint8 code batches (SURVEY.md §7 M0) so the
whole downstream pipeline is static-shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .dna import decode_seq

# Synthetic stand-ins for the acceptance-config genomes (BASELINE.md table 2).
# Real sequences are unavailable offline; sizes match the configs.
GENOME_PRESETS: dict[str, tuple[int, int]] = {
    # name: (length_bases, seed)
    "toy10k": (10_000, 101),
    "lambda": (48_502, 102),
    "ecoli": (4_641_652, 103),
    "yeast": (12_000_000, 104),
}


@dataclasses.dataclass(frozen=True)
class ReadSet:
    """A simulated read batch: fixed-width 2-bit codes plus provenance."""

    codes: np.ndarray  # [B, L] uint8 in {0..3}
    genome: np.ndarray  # [G] uint8 codes, the ground truth
    seed: int
    error_rate: float
    starts: np.ndarray | None = None  # [B] genome start position per read
    flipped: np.ndarray | None = None  # [B] True where reverse-complemented

    @property
    def num_reads(self) -> int:
        return int(self.codes.shape[0])

    @property
    def read_len(self) -> int:
        return int(self.codes.shape[1])

    def strings(self) -> list[str]:
        return [decode_seq(row) for row in self.codes]


def simulate_genome(length: int, seed: int, gc: float = 0.5) -> np.ndarray:
    """Random genome as uint8 codes with the given GC fraction."""
    rng = np.random.default_rng(seed)
    # p over A,C,G,T; complementarity keeps strand-symmetric base composition.
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return rng.choice(4, size=length, p=p).astype(np.uint8)


def preset_genome(name: str) -> np.ndarray:
    length, seed = GENOME_PRESETS[name]
    return simulate_genome(length, seed)


def simulate_genome_multi(
    lengths: list[int], seed: int, gc: float = 0.5
) -> list[np.ndarray]:
    """Independent random chromosomes (SURVEY.md §6: the CFG-4 organism
    is a 16-chromosome yeast; multi-contig assembly needs multi-sequence
    ground truth). Chromosome i draws from its own spawned stream, so
    the set is reproducible from one seed and chromosomes never share
    long subsequences (k-mer cross-hits at k >= 21 are ~G^2/4^k —
    negligible at every acceptance scale)."""
    streams = np.random.SeedSequence(seed).spawn(len(lengths))
    out = []
    for length, ss in zip(lengths, streams):
        rng = np.random.default_rng(ss)
        p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
        out.append(rng.choice(4, size=length, p=p).astype(np.uint8))
    return out


def simulate_reads(
    genome: np.ndarray,
    *,
    coverage: float,
    read_len: int,
    seed: int,
    error_rate: float = 0.0,
    both_strands: bool = True,
    tile_exactly: bool = True,
    tile_k: int | None = None,
    circular: bool = False,
) -> ReadSet:
    """Simulate fixed-length substitution-error reads from ``genome``.

    tile_exactly: in addition to uniform-random starts, include one read at
    a fixed stride so each genome base is covered even at modest coverage.
    The default read_len//2 stride guarantees (for error-free input) that
    every genome k-mer appears for k <= read_len//2 + 1; pass ``tile_k``
    for larger k and the stride shrinks to read_len - k + 1 so no k-mer
    start position falls between tiled reads (the exact-contig acceptance
    bar, BASELINE.md CFG 0). Random starts fill out the coverage
    distribution.

    circular: reads may start at ANY genome position and wrap across the
    origin (the CFG-2/3 organism is a circular E. coli, SURVEY.md §6) —
    implemented by gathering from the genome extended with its own first
    read_len-1 bases, so origin-spanning k-mers appear exactly like any
    other k-mer and the assembled contig closes into one cycle.
    """
    genome = np.asarray(genome, dtype=np.uint8)
    g = len(genome)
    if read_len > g:
        raise ValueError(f"read_len={read_len} > genome length {g}")
    rng = np.random.default_rng(seed)
    source = (
        np.concatenate([genome, genome[: read_len - 1]]) if circular
        else genome
    )
    # legal start positions: 0..g-1 (circular wraps) or 0..g-read_len
    hi = g if circular else g - read_len + 1

    num_reads = int(np.ceil(coverage * g / read_len))
    starts: list[np.ndarray] = []
    if tile_exactly:
        # Consecutive tiled reads at stride s cover every k-mer start
        # position iff s <= read_len - k + 1.
        stride = max(1, read_len // 2)
        if tile_k is not None:
            stride = max(1, min(stride, read_len - tile_k + 1))
        tiled = np.arange(0, hi, stride)
        if not circular and tiled[-1] != g - read_len:
            tiled = np.append(tiled, g - read_len)
        starts.append(tiled)
        num_reads = max(num_reads - len(tiled), 0)
    if num_reads:
        starts.append(rng.integers(0, hi, size=num_reads))
    all_starts = np.concatenate(starts)

    # Gather windows: [B, L]
    idx = all_starts[:, None] + np.arange(read_len)[None, :]
    reads = source[idx]

    if both_strands:
        flip = rng.random(len(all_starts)) < 0.5
        reads[flip] = (3 - reads[flip])[:, ::-1]
    else:
        flip = np.zeros(len(all_starts), dtype=bool)

    if error_rate > 0:
        err_mask = rng.random(reads.shape) < error_rate
        # substitute with a *different* base: add 1..3 mod 4
        bump = rng.integers(1, 4, size=reads.shape).astype(np.uint8)
        reads = np.where(err_mask, (reads + bump) % 4, reads).astype(np.uint8)

    perm = rng.permutation(len(reads))
    return ReadSet(
        codes=reads[perm],
        genome=genome,
        seed=seed,
        error_rate=error_rate,
        starts=all_starts[perm],
        flipped=flip[perm],
    )


def simulate_reads_multi(
    genomes: list[np.ndarray],
    *,
    coverage: float,
    read_len: int,
    seed: int,
    error_rate: float = 0.0,
    tile_k: int | None = None,
    circular: bool | list[bool] = False,
) -> ReadSet:
    """Reads drawn across several chromosomes, shuffled together.

    Each chromosome is sampled independently at the same coverage (its
    read budget scales with its length) with its own derived seed, then
    the pooled reads are permuted — downstream stages see one unordered
    stream, exactly as a real multi-chromosome library arrives.
    ``circular`` may be a single flag or one per chromosome. The
    returned ReadSet's ``genome`` is the concatenation (callers needing
    per-chromosome ground truth keep their ``genomes`` list);
    starts/flipped provenance is dropped (positions would be ambiguous
    across chromosomes)."""
    if isinstance(circular, bool):
        circular = [circular] * len(genomes)
    if len(circular) != len(genomes):
        raise ValueError("circular flags must match the chromosome count")
    parts = []
    for i, (chrom, circ) in enumerate(zip(genomes, circular)):
        rs = simulate_reads(
            chrom,
            coverage=coverage,
            read_len=read_len,
            seed=seed + 7919 * (i + 1),
            error_rate=error_rate,
            tile_k=tile_k,
            circular=circ,
        )
        parts.append(rs.codes)
    codes = np.concatenate(parts, axis=0)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(codes))
    return ReadSet(
        codes=codes[perm],
        genome=np.concatenate([np.asarray(g, np.uint8) for g in genomes]),
        seed=seed,
        error_rate=error_rate,
    )


def pad_to_batch(codes: np.ndarray, batch_reads: int) -> tuple[np.ndarray, int]:
    """Pad [B, L] reads up to a multiple of batch_reads with invalid rows.

    Padding rows are all-A; callers mask them out via the returned true count.
    Keeps every device batch the same static shape (SURVEY.md §7 hard parts).
    """
    b, length = codes.shape
    padded_b = -(-b // batch_reads) * batch_reads
    if padded_b == b:
        return codes, b
    pad = np.zeros((padded_b - b, length), dtype=codes.dtype)
    return np.concatenate([codes, pad], axis=0), b
