"""Assembly statistics + GFA export (contig reporting beyond raw FASTA).

The reference prints contigs only; production assembler users expect
N50-style summary stats and a unitig-graph export (GFA 1.0) for
visualization (e.g. Bandage). Pure host-side reporting on the final
structures.
"""

from __future__ import annotations

import json

from .dbg import UnitigGraph


def contig_stats(contigs: list[str]) -> dict:
    """Standard assembly summary: counts, total size, N50/L50, extremes."""
    if not contigs:
        return {
            "contigs": 0,
            "total_bp": 0,
            "n50": 0,
            "l50": 0,
            "max_len": 0,
            "min_len": 0,
            "mean_len": 0.0,
        }
    lens = sorted((len(c) for c in contigs), reverse=True)
    total = sum(lens)
    acc = 0
    n50 = l50 = 0
    for i, ln in enumerate(lens):
        acc += ln
        if acc * 2 >= total:
            n50 = ln
            l50 = i + 1
            break
    return {
        "contigs": len(lens),
        "total_bp": total,
        "n50": n50,
        "l50": l50,
        "max_len": lens[0],
        "min_len": lens[-1],
        "mean_len": round(total / len(lens), 1),
    }


def stats_json(contigs: list[str]) -> str:
    return json.dumps(contig_stats(contigs))


def write_gfa(graph: UnitigGraph, fh) -> None:
    """Unitig graph as GFA 1.0: S lines per unitig, L lines per adjacency.

    Link overlap is the (k-1)-mer node shared by the two unitigs; every
    link is emitted on the + strand of both segments (the graph already
    carries both orientations explicitly, so no +/- flips are needed).
    """
    k = graph.k
    fh.write("H\tVN:Z:1.0\n")
    for i, u in enumerate(graph.unitigs):
        fh.write(
            f"S\tu{i}\t{u.seq}\tDP:f:{u.cov:.2f}\tLN:i:{len(u.seq)}\n"
        )
    for i, u in enumerate(graph.unitigs):
        for j in graph.out_ids(u.end):
            fh.write(f"L\tu{i}\t+\tu{j}\t+\t{k - 1}M\n")
