"""The plain reference of an exact de Bruijn assembly, and its check.

Plain ``torch`` (on the card where there is one) and NumPy; nothing of
the program. From the reads alone it counts every window's canonical
k-mer exactly, keeps those seen ``min_count`` times or more, and spells
the maximal non-branching paths of the k-mer graph (nodes are
(k-1)-mers, a k-mer is an edge; a path stops at a node with other than
one edge in and one out), each with its number of edges and the sum of
their multiplicities. Contigs are those paths' sequences in canonical
form (the lesser of a sequence and its reverse complement), each once.

What it leaves out: the program's tip, bubble and island removal, which
has nothing to remove in an error-free read set of a genome without
repeats of k-1 bases or more (the mixes that use this reference), and
cycles, which such a genome does not make: a run whose graph holds one
raises, and decides nothing. Keys are one int64 of 2k bits, so k <= 31.

``compare`` holds an assembly's contigs and unitigs to the answer. The
numbers it gives are counts of unmatched items, each held to 0
(``LIMITS``): the program's answer is exact or wrong.

``control`` is the same reference with the nearest lower precision of
its keys: the table keyed by a 32-bit hash of each 62-bit key. K-mers
that collide share an entry; on a genome of millions of k-mers thousands
collide, their paths break and their coverage mixes, and ``compare``
fails it on both numbers.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

LIMITS = {"contigs_unmatched": 0, "unitigs_unmatched": 0}
CHUNK_READS = 1 << 20
_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)
_COMP = str.maketrans("ACGT", "TGCA")
_HASH_MUL = 0x9E3779B97F4A7C15 - (1 << 64)  # as a signed int64


@dataclasses.dataclass
class Answer:
    """Canonical contigs, and each canonical unitig's (edges, cov_sum)."""

    contigs: list[str]
    unitigs: dict[str, tuple[int, int]]


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def canonical(seq: str) -> str:
    rc = revcomp(seq)
    return seq if seq <= rc else rc


def window_keys(reads: torch.Tensor, k: int):
    """[b, L] uint8 codes -> (forward keys, reverse-complement keys) of the
    windows that hold no N, int64, 2 bits a base, first base highest."""
    r = reads.to(torch.int64)
    w = r.shape[1] - k + 1
    fwd = torch.zeros((r.shape[0], w), dtype=torch.int64, device=r.device)
    rc = torch.zeros_like(fwd)
    for p in range(k):
        col = r[:, p: p + w]
        fwd = fwd * 4 + col
        rc = rc + ((3 - col) << (2 * p))
    bad = torch.cumsum(torch.nn.functional.pad((r > 3).to(torch.int32),
                                               (1, 0)), dim=1)
    ok = (bad[:, k:] - bad[:, :w]) == 0
    return fwd[ok], rc[ok]


def hash32(keys: torch.Tensor) -> torch.Tensor:
    """A multiplicative 32-bit hash of int64 keys (the control's key)."""
    return ((keys * _HASH_MUL) >> 32) & 0xFFFFFFFF


def count_canonical(reads: np.ndarray, k: int, device, key_fn=None):
    """(sorted distinct canonical keys, their counts) over every window,
    in chunks of reads; ``key_fn`` maps the keys before counting."""
    keys, counts = [], []
    for lo in range(0, reads.shape[0], CHUNK_READS):
        chunk = torch.from_numpy(reads[lo: lo + CHUNK_READS]).to(device)
        fwd, rc = window_keys(chunk, k)
        canon = torch.minimum(fwd, rc)
        del fwd, rc, chunk
        if key_fn is not None:
            canon = key_fn(canon)
        u, c = torch.unique(canon, return_counts=True)
        keys.append(u)
        counts.append(c)
        del canon
    u, inv = torch.unique(torch.cat(keys), return_inverse=True)
    total = torch.zeros(len(u), dtype=torch.int64, device=u.device)
    total.index_add_(0, inv, torch.cat(counts))
    return u, total


def revcomp_keys(keys: torch.Tensor, k: int) -> torch.Tensor:
    out = torch.zeros_like(keys)
    for p in range(k):
        out = (out << 2) | (3 - ((keys >> (2 * p)) & 3))
    return out


def _count(sorted_vals: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    return (torch.searchsorted(sorted_vals, queries, right=True)
            - torch.searchsorted(sorted_vals, queries))


def unitigs(keys: torch.Tensor, mult: torch.Tensor, k: int):
    """Maximal non-branching paths of the k-mer graph of canonical
    ``keys`` with multiplicities ``mult``, over both strands: a list of
    (sequence, edges, cov_sum), each path and its reverse complement."""
    both, inv = torch.unique(torch.cat([keys, revcomp_keys(keys, k)]),
                             return_inverse=True)
    m = torch.zeros(len(both), dtype=torch.int64, device=both.device)
    m.scatter_(0, inv, torch.cat([mult, mult]))
    n = len(both)
    if n == 0:
        return []
    idx = torch.arange(n, device=both.device)
    pre = both >> 2  # the edge's first node, sorted as ``both`` is
    suf = both & ((1 << (2 * (k - 1))) - 1)  # its second node
    suf_sorted = torch.sort(suf).values

    def junction(node):
        return (_count(pre, node) != 1) | (_count(suf_sorted, node) != 1)

    head = junction(pre)
    link = ~junction(suf)
    nxt = torch.searchsorted(pre, suf)
    prv = idx.clone()  # a path's first edge points at itself
    prv[nxt[link]] = idx[link]
    # pointer jumping: every edge finds its path's first edge and its rank
    dist = (~head).to(torch.int64)
    for _ in range(max(1, int(n).bit_length()) + 1):
        dist = dist + dist[prv]
        prv = prv[prv]
    if not bool(head[prv].all()):
        raise NotImplementedError(
            "reference: the k-mer graph holds a cycle without a junction")
    order = torch.argsort(prv * n + dist)
    first = head.nonzero().flatten()  # path ids in the order of ``order``
    lengths = torch.bincount(prv, minlength=n)[first]
    cov = torch.zeros(n, dtype=torch.int64, device=both.device)
    cov.index_add_(0, prv, m)
    cov = cov[first]
    # spelling: a path's first edge gives k bases, each later edge its last
    seq_len = lengths + (k - 1)
    offsets = torch.cumsum(seq_len, 0) - seq_len
    buf = torch.empty(int(seq_len.sum()), dtype=torch.uint8,
                      device=both.device)
    shifts = 2 * torch.arange(k - 1, -1, -1, device=both.device)
    pos = offsets[:, None] + torch.arange(k, device=both.device)
    buf[pos.flatten()] = ((both[first][:, None] >> shifts) & 3).to(
        torch.uint8).flatten()
    path_of = torch.searchsorted(first, prv[order])
    later = dist[order] > 0
    buf[offsets[path_of[later]] + (k - 1) + dist[order][later]] = (
        both[order][later] & 3).to(torch.uint8)
    text = _DECODE[buf.cpu().numpy()].tobytes().decode()
    offsets, seq_len = offsets.tolist(), seq_len.tolist()
    return [(text[o: o + s], e, c) for o, s, e, c in
            zip(offsets, seq_len, lengths.tolist(), cov.tolist())]


def _answer(paths) -> Answer:
    tigs = {}
    for seq, edges, cov in paths:
        tigs[canonical(seq)] = (edges, cov)
    return Answer(contigs=sorted(tigs), unitigs=tigs)


def _keep(keys, counts, min_count: int):
    if min_count < 1:
        raise NotImplementedError("reference: min_count 0 (auto) is not "
                                  "implemented")
    keep = counts >= min_count
    return keys[keep], counts[keep]


def answer(reads: np.ndarray, config: dict, device) -> Answer:
    """The exact assembly of ``reads`` under ``config``."""
    k = int(config["assembly"]["k"])
    if k > 31:
        raise NotImplementedError("reference: keys of one int64, k <= 31")
    keys, counts = count_canonical(reads, k, device)
    keys, counts = _keep(keys, counts, int(config["assembly"]["min_count"]))
    return _answer(unitigs(keys, counts, k))


def control(reads: np.ndarray, config: dict, device) -> Answer:
    """``answer`` from a table keyed by a 32-bit hash of each k-mer's key,
    as a counter that keys its table by hashes: k-mers that collide share
    one entry, which keeps the least of their keys and the sum of their
    counts, so the others drop out of the graph."""
    k = int(config["assembly"]["k"])
    keys, counts = count_canonical(reads, k, device)
    h, order = torch.sort(hash32(keys), stable=True)
    _, slot = torch.unique_consecutive(h, return_inverse=True)
    kept = torch.full((int(slot.max()) + 1,) if len(slot) else (0,),
                      torch.iinfo(torch.int64).max, dtype=torch.int64,
                      device=keys.device)
    kept.scatter_reduce_(0, slot, keys[order], reduce="amin")
    summed = torch.zeros_like(kept).index_add_(0, slot, counts[order])
    kept, by_key = torch.sort(kept)
    kept, summed = _keep(kept, summed[by_key],
                         int(config["assembly"]["min_count"]))
    return _answer(unitigs(kept, summed, k))


def compare(contigs: list[str], unitig_rows, want: Answer) -> dict[str, int]:
    """Counts of what one assembly gets wrong against ``want``:
    ``contigs_unmatched``, the contigs in one list and not the other
    (as multisets), and ``unitigs_unmatched``, the canonical unitigs
    whose (edges, cov_sum) differ from the answer's or are missing on
    either side, a unitig whose two strands disagree counted too.
    ``unitig_rows`` gives (sequence, edges, cov_sum) per unitig."""
    got, ref = collections.Counter(contigs), collections.Counter(want.contigs)
    contigs_off = sum(((got - ref) + (ref - got)).values())
    tigs: dict[str, tuple[int, int]] = {}
    torn = 0
    for seq, edges, cov in unitig_rows:
        key, val = canonical(seq), (int(edges), int(cov))
        if tigs.setdefault(key, val) != val:
            torn += 1
    unitigs_off = torn + sum(
        tigs.get(key) != want.unitigs.get(key)
        for key in set(tigs) | set(want.unitigs))
    return {"contigs_unmatched": contigs_off, "unitigs_unmatched": unitigs_off}
