"""Oracle assembler: the reference-equivalent host implementation (M1).

SURVEY.md §7 M1: a small, clear CPU implementation of the full pipeline
(count -> filter -> graph -> tips/bubbles -> Euler -> contigs) that defines
ground-truth contigs for every test and acceptance config. The reference
mount is empty this round (SURVEY.md §0), so this oracle *is* the stand-in
for "the reference assembler's contigs"; it follows the reconstructed
pipeline of SURVEY.md §3.1 stage for stage.

Two counting paths:
  * ``count_canonical_dict`` — straight-line dict/str counting, shaped like
    the reference's hot loop (SURVEY.md §3.3); used on tiny inputs and to
    validate the vectorized path.
  * ``count_canonical_fast`` — NumPy rolling-pack counting (ops/kmer_ref),
    bit-compatible with the TPU kernels; used for multi-Mb oracle runs.

Graph/simplify/traverse are the *shared* host modules, so oracle-vs-TPU
contig equality reduces to counting-stage equality.
"""

from __future__ import annotations

import numpy as np

from ..host.dbg import counts_to_dict
from ..host.simplify import simplify_counts
from ..host.traverse import emit_contigs
from ..ops.kmer_ref import count_canonical_np
from ..utils.config import AssemblyConfig
from ..utils.dna import canonical_str, decode_seq


def count_canonical_dict(
    reads: list[str] | np.ndarray, k: int
) -> dict[str, int]:
    """Reference-style canonical k-mer counting (dict upsert per window)."""
    if isinstance(reads, np.ndarray):
        reads = [decode_seq(row) for row in reads]
    acgt = set("ACGT")
    counts: dict[str, int] = {}
    for read in reads:
        clean = set(read) <= acgt
        for i in range(len(read) - k + 1):
            window = read[i : i + k]
            if not clean and not set(window) <= acgt:
                continue  # ambiguous-base windows are masked, not counted
            kmer = canonical_str(window)
            counts[kmer] = counts.get(kmer, 0) + 1
    return counts


def count_canonical_fast(reads: np.ndarray, k: int) -> dict[str, int]:
    """Vectorized canonical counting, identical results to the dict path."""
    uniq, counts = count_canonical_np(np.asarray(reads, dtype=np.uint8), k)
    return counts_to_dict(uniq, counts, k)


def assemble_from_counts(
    counts: dict[str, int], cfg: AssemblyConfig, emit: str = "unitigs"
) -> list[str]:
    """Filter + graph + simplify + traverse (shared back half).

    emit: "unitigs" (default — contigs stop at junctions) or "euler"
    (reference-parity mode — contigs spelled from Eulerian walks, mirrored
    on the TPU path so oracle-vs-TPU equality holds in both modes).
    """
    min_count = cfg.min_count
    if min_count == 0:  # auto threshold, same heuristic as the TPU path
        from .pipeline import auto_min_count

        min_count = auto_min_count(
            np.fromiter(counts.values(), dtype=np.int64, count=len(counts))
        )
    kept = {km: c for km, c in counts.items() if c >= min_count}
    graph = simplify_counts(
        kept, cfg.k, cfg.resolved_tip_len, cfg.resolved_bubble_len,
        min_count,
    )
    if emit == "euler":
        from ..host.traverse import emit_contigs_euler

        return emit_contigs_euler(graph)
    return emit_contigs(graph)


def assemble_oracle(
    reads: list[str] | np.ndarray,
    cfg: AssemblyConfig,
    *,
    fast_count: bool = True,
    emit: str = "unitigs",
) -> list[str]:
    """End-to-end oracle assembly: reads -> canonical contigs."""
    if fast_count and isinstance(reads, np.ndarray):
        counts = count_canonical_fast(reads, cfg.k)
    else:
        counts = count_canonical_dict(reads, cfg.k)
    return assemble_from_counts(counts, cfg, emit)
