"""Eulerian traversal + contig emission (reference C8/C9).

Hierholzer's algorithm over the *unitig* graph (each unitig is one edge),
per SURVEY.md §3.4: the non-branching 95% was already compressed, so this
walks thousands of edges, not millions. Deterministic by construction:
  * start nodes: maximize available (out - in) imbalance, tie-break on the
    lexicographically smallest node label;
  * edge choice: lexicographically smallest unitig sequence (then id).
Repeats until every unitig edge is consumed; each walk spells one contig.

Contigs are reported canonically (min of sequence and its reverse
complement), deduplicated — the strand-symmetric graph yields every walk
twice, once per strand — and sorted by (length desc, sequence asc), matching
the acceptance bar "equality up to reverse-complement and contig ordering"
(BASELINE.md).
"""

from __future__ import annotations

import contextlib
import contextvars

from ..utils.dna import canonical_str, canonical_str_flipped
from .dbg import UnitigGraph

# the Metrics that emission inside a ``counted_into`` block counts into
_COUNTED_INTO: contextvars.ContextVar = contextvars.ContextVar(
    "emission_metrics", default=None
)


@contextlib.contextmanager
def counted_into(metrics):
    """Emission inside the block counts ``revcomp_bases`` into metrics:
    the bases of every reverse complement it built (a linear contig taken
    from its other strand; every cycle's core, canonicalised over both
    strands). The pipelines' ``traverse`` stage counts so, and its call
    stays ``emit_contigs(graph)``: a stand-in for emission may be a
    function of the graph alone."""
    token = _COUNTED_INTO.set(metrics)
    try:
        yield
    finally:
        _COUNTED_INTO.reset(token)


def _count_revcomp_bases(n: int) -> None:
    m = _COUNTED_INTO.get()
    if m is not None:
        m.count("revcomp_bases", n)


def euler_walks(g: UnitigGraph) -> list[list[int]]:
    """Decompose the unitig graph into deterministic edge-covering walks.

    Hierholzer's emit-on-pop construction is only valid on *balanced*
    components (every node in == out); branchy assembly graphs have many
    imbalanced junctions, where the naive stack walk emits non-contiguous
    edge sequences. So the graph is first balanced with virtual edges from
    each in-surplus node (sink) to an out-surplus node (source), paired in
    sorted node order; Eulerian circuits of the balanced multigraph are
    then split at the virtual edges, leaving only contiguous real walks
    (each from a source to a sink, plus pure cycles).

    Deterministic throughout: virtual pairing by sorted node label, circuit
    starts at the smallest node with unused edges, real edges chosen by
    lexicographically smallest unitig sequence (then id) before virtual.
    """
    unused: dict[str, list[int]] = {
        node: sorted(ids, key=lambda i: (g.unitigs[i].seq, i), reverse=True)
        for node, ids in g.out_adj.items()
    }
    out_deg = {node: len(ids) for node, ids in unused.items()}
    in_deg = {node: len(ids) for node, ids in g.in_adj.items()}
    nodes = sorted(set(out_deg) | set(in_deg))
    imb = {n: out_deg.get(n, 0) - in_deg.get(n, 0) for n in nodes}
    sources = [n for n in nodes for _ in range(max(imb[n], 0))]
    sinks = [n for n in nodes for _ in range(max(-imb[n], 0))]
    vadj: dict[str, list[str]] = {}
    for sink, source in zip(sinks, sources):
        vadj.setdefault(sink, []).append(source)
    for lst in vadj.values():
        lst.sort(reverse=True)

    remaining = sum(out_deg.values()) + len(sources)
    VIRTUAL = -1
    circuits: list[list[int]] = []
    # smallest node with unused edges via an advancing cursor: a node's
    # edges are only ever consumed, so exhausted nodes never revive and
    # the scan is O(V) total instead of O(V) per circuit (fragmented
    # graphs have one circuit per component)
    cursor = 0
    while remaining:
        while not (unused.get(nodes[cursor]) or vadj.get(nodes[cursor])):
            cursor += 1
        start = nodes[cursor]
        stack: list[tuple[str, int | None]] = [(start, None)]
        circuit: list[int] = []
        while stack:
            node, _ = stack[-1]
            ids = unused.get(node)
            if ids:
                eid = ids.pop()
                remaining -= 1
                stack.append((g.unitigs[eid].end, eid))
            elif vadj.get(node):
                target = vadj[node].pop()
                remaining -= 1
                stack.append((target, VIRTUAL))
            else:
                _, eid = stack.pop()
                if eid is not None:
                    circuit.append(eid)
        circuit.reverse()
        circuits.append(circuit)

    walks: list[list[int]] = []
    for circuit in circuits:
        vpos = [i for i, e in enumerate(circuit) if e == VIRTUAL]
        if not vpos:
            walks.append(circuit)
            continue
        # rotate to start just past a virtual edge, then cut at the rest
        rot = circuit[vpos[0] + 1 :] + circuit[: vpos[0]]
        seg: list[int] = []
        for e in rot:
            if e == VIRTUAL:
                if seg:
                    walks.append(seg)
                seg = []
            else:
                seg.append(e)
        if seg:
            walks.append(seg)
    return walks


def spell_walk(g: UnitigGraph, walk: list[int]) -> str:
    parts = [g.unitigs[walk[0]].seq]
    overlap = g.k - 1
    parts.extend(g.unitigs[eid].seq[overlap:] for eid in walk[1:])
    return "".join(parts)


def _canonical_kmer_keys(seq: str, k: int) -> "np.ndarray":
    """Packed canonical k-mer keys of a sequence as a u64-column array."""
    from ..ops.kmer_ref import _to_u64_cols, extract_canonical_np
    from ..utils.dna import encode_seq

    codes = encode_seq(seq)[None, :]
    return _to_u64_cols(extract_canonical_np(codes, k))


def emit_contigs(g: UnitigGraph, min_len: int | None = None) -> list[str]:
    """Simplified unitigs -> canonical, deduplicated, ordered contigs."""
    return [seq for seq, _ in emit_contigs_with_cov(g, min_len)]


def emit_contigs_with_cov(
    g: UnitigGraph, min_len: int | None = None
) -> list[tuple[str, float]]:
    """Contigs with their mean k-mer coverage (for FASTA headers/reports).

    Contigs are the maximal unambiguous sequences: the simplified unitigs.
    Stitching through a branching junction would pick an arbitrary pairing
    of in/out edges (repeats longer than k-1 make the continuation
    genuinely ambiguous — and the choice differs between a walk and its
    reverse-complement mirror), so, as in production assemblers, contigs
    stop at junctions; non-branching runs were already merged by unitig
    compression, which is exactly the Eulerian path on every clean
    component (SURVEY.md §3.4 restructuring).

    Strand handling: the unitig set is perfectly strand-symmetric, so
    canonical-sequence dedupe collapses each reverse-complement twin pair.
    Circular unitigs (start node == end node) linearize at an arbitrary
    strand-dependent break; they are re-linearized at the lexicographically
    least rotation over both strands (Booth) before dedupe.
    """
    from ..utils.dna import canonical_cycle

    min_len = g.k if min_len is None else min_len
    overlap = g.k - 1
    seen: set[str] = set()
    contigs: list[tuple[str, float]] = []
    rc_bases = 0
    for u in g.unitigs:
        if u.start == u.end and u.edges > 1:
            # circular: drop the duplicated (k-1)-overlap, canonicalize the
            # rotation, and re-wrap for a linear representation
            core = canonical_cycle(u.seq[: len(u.seq) - overlap])
            rc_bases += len(core)
            seq = core + core[:overlap]
        else:
            seq, flipped = canonical_str_flipped(u.seq)
            rc_bases += len(seq) if flipped else 0
        if len(seq) >= min_len and seq not in seen:
            seen.add(seq)
            contigs.append((seq, u.cov))
    contigs.sort(key=lambda sc: (-len(sc[0]), sc[0]))
    _count_revcomp_bases(rc_bases)
    return contigs


def emit_contigs_euler(g: UnitigGraph, min_len: int | None = None) -> list[str]:
    """Eulerian-emission mode: contigs spelled from full edge-covering walks."""
    return [seq for seq, _ in emit_contigs_euler_with_cov(g, min_len)]


def emit_contigs_euler_with_cov(
    g: UnitigGraph, min_len: int | None = None
) -> list[tuple[str, float]]:
    """Contigs from deterministic Eulerian walks (reference-parity mode).

    The reference's pipeline spells contigs from ``eulerian_path`` over the
    cleaned graph (SURVEY.md §3.1/§3.4), which walks *through* junctions;
    the default emission (emit_contigs) stops at junctions because the
    continuation there is ambiguous. This mode mirrors the reference
    behavior instead: decompose the unitig graph into edge-covering walks
    (euler_walks — deterministic start and edge tie-breaks) and spell each
    walk as one contig.

    Strand handling matches emit_contigs: the strand-symmetric graph yields
    every walk's reverse-complement twin, collapsed by canonical dedupe;
    closed walks (start node == end node) re-linearize at the Booth least
    rotation over both strands before dedupe.
    """
    from ..utils.dna import canonical_cycle

    min_len = g.k if min_len is None else min_len
    overlap = g.k - 1
    seen: set[str] = set()
    contigs: list[tuple[str, float]] = []
    rc_bases = 0
    for walk in euler_walks(g):
        seq = spell_walk(g, walk)
        edges = sum(g.unitigs[i].edges for i in walk)
        cov = sum(g.unitigs[i].cov_sum for i in walk) / edges
        closed = (
            g.unitigs[walk[0]].start == g.unitigs[walk[-1]].end
            and len(seq) > overlap
        )
        if closed and edges > 1:
            core = canonical_cycle(seq[: len(seq) - overlap])
            rc_bases += len(core)
            seq = core + core[:overlap]
        else:
            seq, flipped = canonical_str_flipped(seq)
            rc_bases += len(seq) if flipped else 0
        if len(seq) >= min_len and seq not in seen:
            seen.add(seq)
            contigs.append((seq, cov))
    contigs.sort(key=lambda sc: (-len(sc[0]), sc[0]))
    _count_revcomp_bases(rc_bases)
    return contigs


def canonicalize_contigs(contigs: list[str]) -> list[str]:
    """Normalize any contig list for comparison (canonical, dedup, sorted)."""
    out = sorted({canonical_str(c) for c in contigs}, key=lambda s: (-len(s), s))
    return out


def contigs_equal(a: list[str], b: list[str]) -> bool:
    """Equality up to reverse complement and contig ordering (BASELINE.md)."""
    return canonicalize_contigs(a) == canonicalize_contigs(b)


def expected_contigs_multi(
    genomes: list[str], k: int, circular: bool | list[bool] = False
) -> list[str]:
    """The contig set a perfect assembly emits for these chromosomes.

    A linear chromosome reconstructs as itself (compared canonically);
    a circular one emits its cycle at the Booth least rotation over both
    strands, re-wrapped with the first k-1 bases — exactly the
    representation emit_contigs/emit_contigs_euler produce for closed
    walks, so ``contigs_equal(contigs, expected_contigs_multi(...))`` is
    the per-chromosome exactness bar for multi-chromosome and circular
    acceptance runs (SURVEY.md §4: round-trip up to rotation for
    circular genomes; §6: 16-chromosome yeast, circular E. coli)."""
    from ..utils.dna import canonical_cycle

    if isinstance(circular, bool):
        circular = [circular] * len(genomes)
    out = []
    for g_str, circ in zip(genomes, circular):
        if circ:
            core = canonical_cycle(g_str)
            out.append(core + core[: k - 1])
        else:
            out.append(canonical_str(g_str))
    return out


def kmer_content_equal(contigs: list[str], genome: str, k: int) -> bool:
    """Contigs spell exactly the genome's canonical k-mer set, once.

    The honest bar when repeats shorter than the genome but longer than
    k-1 make single-contig reconstruction ambiguous (BASELINE.md CFG 3
    "repeat-induced branching"): every genome k-mer present, no foreign
    k-mers, and no k-mer spelled by two contigs (i.e. total length is the
    genome's plus the k-1 overlap loss per extra contig, up to the repeat
    multiplicity ambiguity).
    """
    import numpy as np

    want = np.unique(_canonical_kmer_keys(genome, k), axis=0)
    got_parts = [_canonical_kmer_keys(c, k) for c in contigs if len(c) >= k]
    if not got_parts:
        return len(want) == 0
    got_all = np.concatenate(got_parts)
    got = np.unique(got_all, axis=0)
    if got.shape != want.shape or not (got == want).all():
        return False
    # each k-mer spelled at most ~once beyond repeat multiplicity: total
    # spelled k-mer instances should not exceed the genome's window count
    total_windows = sum(len(c) - k + 1 for c in contigs if len(c) >= k)
    return total_windows <= (len(genome) - k + 1)
