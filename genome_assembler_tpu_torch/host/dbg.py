"""Host-side De Bruijn graph + unitig compression (branchy residue).

Capability parity: reference components C5 (graph build) and the host half of
the TPU design's M4 split (SURVEY.md §7): the device compresses the
non-branching 95%; this module handles graph semantics, the host fallback
compression, and the small branchy graph that tips/bubbles/Euler operate on.
It is shared verbatim by the oracle assembler and the TPU pipeline, so the
two paths can only diverge in the counting stage.

Normative graph semantics (both paths MUST follow these; the reference mount
is empty this round, SURVEY.md §0, so this spec is the blueprint of record):
  * Count canonical k-mers (min of k-mer and revcomp), filter < min_count.
  * The directed graph contains BOTH orientations of every surviving
    canonical k-mer, each with the canonical multiplicity (strand-symmetric
    graph; contigs are deduplicated canonically at the end).
  * Nodes are (k-1)-mers; edge k-mer e runs prefix(e) -> suffix(e).
  * A node is a *junction* iff indeg != 1 or outdeg != 1. Unitigs are maximal
    chains whose internal nodes are non-junctions; isolated cycles are broken
    deterministically at their lexicographically smallest edge.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.dna import _DECODE_LUT, revcomp_str


def words_to_strings(words: np.ndarray, k: int) -> list[str]:
    """Vectorized [U, W] uint32 big-endian keys -> list of k-mer strings."""
    words = np.asarray(words, dtype=np.uint32)
    u, w = words.shape
    bases = np.empty((u, k), dtype=np.uint8)
    for j in range(k):
        pos = 2 * (k - 1 - j)
        widx = w - 1 - pos // 32
        bases[:, j] = (words[:, widx] >> np.uint32(pos % 32)) & np.uint32(3)
    raw = _DECODE_LUT[bases].tobytes()
    return [raw[i * k : (i + 1) * k].decode() for i in range(u)]


def counts_to_dict(words: np.ndarray, counts: np.ndarray, k: int) -> dict[str, int]:
    """(unique canonical keys, counts) arrays -> {canonical k-mer: count}."""
    return dict(zip(words_to_strings(words, k), (int(c) for c in counts)))


def both_strand_edges(canonical_counts: dict[str, int]) -> dict[str, int]:
    """Expand canonical counts to the strand-symmetric directed edge set."""
    edges: dict[str, int] = {}
    for kmer, count in canonical_counts.items():
        edges[kmer] = count
        edges[revcomp_str(kmer)] = count
    return edges


@dataclasses.dataclass
class Unitig:
    """A maximal non-branching chain, spelled as one sequence.

    seq:     the spelled bases; len(seq) == (k-1) + edge count.
    cov_sum: summed multiplicity of the constituent k-mer edges — kept
             exact (integer) so every coverage comparison in
             simplification is a pure function of integers: the derived
             mean is one IEEE f64 division, identical across the oracle,
             device, and array paths (no float accumulation order to
             diverge on).
    edges:   number of k-mer edges in the chain.
    """

    seq: str
    cov_sum: int
    edges: int
    k: int

    @property
    def cov(self) -> float:
        """Mean multiplicity of the constituent k-mer edges."""
        return self.cov_sum / self.edges

    @property
    def start(self) -> str:
        return self.seq[: self.k - 1]

    @property
    def end(self) -> str:
        return self.seq[-(self.k - 1) :]


@dataclasses.dataclass
class UnitigGraph:
    """Unitig-level view of the De Bruijn graph."""

    k: int
    unitigs: list[Unitig]
    out_adj: dict[str, list[int]]  # node -> unitig ids starting there
    in_adj: dict[str, list[int]]  # node -> unitig ids ending there

    def out_ids(self, node: str) -> list[int]:
        return self.out_adj.get(node, [])

    def in_ids(self, node: str) -> list[int]:
        return self.in_adj.get(node, [])


def compress_unitigs(edges: dict[str, int], k: int) -> list[Unitig]:
    """Directed k-mer edge dict -> maximal non-branching chains.

    Deterministic: edges are visited in sorted order, so unitig numbering and
    cycle break points are reproducible across runs and across the
    oracle/TPU paths (SURVEY.md §7 hard parts: deterministic tie-breaking).
    """
    out_edges: dict[str, list[str]] = {}
    indeg: dict[str, int] = {}
    for kmer in edges:
        out_edges.setdefault(kmer[:-1], []).append(kmer)
        indeg[kmer[1:]] = indeg.get(kmer[1:], 0) + 1
    for lst in out_edges.values():
        lst.sort()

    def outdeg(node: str) -> int:
        return len(out_edges.get(node, ()))

    def is_junction(node: str) -> bool:
        return indeg.get(node, 0) != 1 or outdeg(node) != 1

    consumed: set[str] = set()
    unitigs: list[Unitig] = []

    def walk(first: str, stop_node: str | None) -> None:
        """Extend a chain from ``first`` until a junction (or ``stop_node``)."""
        chain = [first]
        consumed.add(first)
        node = first[1:]
        while not is_junction(node) and node != stop_node:
            nxt = out_edges[node][0]
            if nxt in consumed:
                break
            chain.append(nxt)
            consumed.add(nxt)
            node = nxt[1:]
        seq = chain[0] + "".join(e[-1] for e in chain[1:])
        cov_sum = sum(edges[e] for e in chain)
        unitigs.append(Unitig(seq=seq, cov_sum=cov_sum, edges=len(chain), k=k))

    # Pass 1: chains anchored at junctions.
    for kmer in sorted(edges):
        if kmer not in consumed and is_junction(kmer[:-1]):
            walk(kmer, stop_node=None)
    # Pass 2: isolated cycles (every node non-junction); break at the
    # lexicographically smallest remaining edge.
    for kmer in sorted(edges):
        if kmer not in consumed:
            walk(kmer, stop_node=kmer[:-1])
    return unitigs


def build_unitig_graph(unitigs: list[Unitig], k: int) -> UnitigGraph:
    out_adj: dict[str, list[int]] = {}
    in_adj: dict[str, list[int]] = {}
    for i, u in enumerate(unitigs):
        out_adj.setdefault(u.start, []).append(i)
        in_adj.setdefault(u.end, []).append(i)
    return UnitigGraph(k=k, unitigs=unitigs, out_adj=out_adj, in_adj=in_adj)


def unitig_graph_from_counts(
    canonical_counts: dict[str, int], k: int
) -> UnitigGraph:
    """Canonical counts -> strand-symmetric unitig graph (host fallback path)."""
    edges = both_strand_edges(canonical_counts)
    return build_unitig_graph(compress_unitigs(edges, k), k)


def unitig_kmers(u: Unitig) -> list[str]:
    """The k-mer edges a unitig spells (used when deleting it from the graph)."""
    return [u.seq[i : i + u.k] for i in range(u.edges)]


def spell_device_arrays(dev, k: int):
    """Spell ops.unitig_torch.DeviceUnitigs into columnar UnitigArrays.

    The device reduces the edge table to a compact transfer set
    (ops.unitig_torch.spell_arrays: the (uid, pos)-sorted base stream plus
    per-unitig head limbs / lengths / coverage sums); only that set
    crosses to the host. Host assembly is pure vectorized NumPy (np.repeat
    segment fills) into the packed-code representation that array-native
    simplification (host.simplify_arrays) consumes directly: no Python
    strings exist until the final simplified graph is materialized.

    One scalar read sizes the per-unitig transfer from ``num_unitigs`` on
    the snug grid; that cap is never below ``num_unitigs`` (which is at
    most E), so the reduction cannot overflow it.
    """
    from ..ops.unitig_torch import spell_arrays
    from ..utils.dna import key_words, unpack_codes_np
    from ..utils.keys import limbs_to_words, snug_capacity
    from .simplify_arrays import build_unitig_arrays

    e = dev.edge_limbs.shape[0]
    arrs = spell_arrays(
        dev, min(e, snug_capacity(int(dev.num_unitigs), floor=1 << 12))
    )
    u = int(arrs.num_unitigs)
    if u == 0:  # e.g. a coverage filter that dropped every k-mer
        return build_unitig_arrays(
            np.empty(0, np.uint8), np.empty(0, np.int64),
            np.empty(0, np.int64), np.empty((0, key_words(k)), np.uint32), k,
        )
    lengths = arrs.lengths[:u].cpu().numpy().astype(np.int64)
    cov_sum = arrs.cov_sum[:u].cpu().numpy().astype(np.int64)
    head_words = limbs_to_words(arrs.head_limbs[:u].cpu().numpy(), k)
    total_body = int(lengths.sum())
    packed = arrs.bases[: (total_body + 3) // 4].cpu().numpy()
    bases = unpack_codes_np(packed, total_body)
    return build_unitig_arrays(bases, lengths, cov_sum, head_words, k)


def spell_device_unitigs(dev, k: int) -> list[Unitig]:
    """Spell DeviceUnitigs into host Unitig objects (string form).

    Thin decode over spell_device_arrays, kept for the debug/oracle
    comparison surfaces; the pipeline feeds the arrays form straight into
    array-native simplification.
    """
    from .simplify_arrays import to_unitig_list

    return to_unitig_list(spell_device_arrays(dev, k))
