"""Core DNA data model: 2-bit base encoding and multi-word k-mer keys.

Capability parity: the reference assembler's k-mer/reverse-complement string
utilities (SURVEY.md §2.1 C2-C3; reference mount empty this round — see
SURVEY.md §0, so citations are to the survey's reconstruction, not file:line).

Design (TPU-first, SURVEY.md §7 M0):
  * Bases are 2-bit codes A=0, C=1, G=2, T=3 so that complement(x) == 3 - x.
  * A k-mer is a 2k-bit big-endian integer (first base in the highest bits),
    stored as ``W = 2k//32 + 1`` uint32 words, word 0 = most significant.
    Big-endian packing makes lexicographic word-tuple order identical to
    lexicographic base-string order, so multi-operand ``lax.sort`` over the
    word columns sorts k-mers correctly even for 2k > 64 (k=41 -> 82 bits,
    SURVEY.md §7 "hard parts").
  * ``W`` always leaves >= 2 spare high bits zero for valid k-mers, so the
    all-ones word tuple is a safe +inf sentinel for padding/invalid lanes.

This module is NumPy/str only (host side); the JAX/Pallas equivalents live in
``genome_assembler_tpu.ops``.
"""

from __future__ import annotations

import numpy as np

BASES = "ACGT"
A, C, G, T = 0, 1, 2, 3
# Ambiguous/invalid bases (N etc.) encode to 4: every k-mer window that
# touches one is masked to the sentinel key instead of aborting the run
# (real read sets contain Ns; reference C1 parses plain reads, SURVEY.md
# §2.1 / VERDICT r1 item 7). Code 4 decodes back to 'N'.
INVALID_CODE = 4

_ENCODE_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(BASES):
    _ENCODE_LUT[ord(_b)] = _i
    _ENCODE_LUT[ord(_b.lower())] = _i

_DECODE_LUT = np.frombuffer((BASES + "N").encode(), dtype=np.uint8)


def encode_seq(seq: str, mask_invalid: bool = False) -> np.ndarray:
    """ACGT string -> uint8 code array.

    mask_invalid=False (strict: simulator/test inputs) raises on any
    non-ACGT character; mask_invalid=True (real read data) encodes it as
    INVALID_CODE so downstream extraction masks the affected windows.
    """
    raw = np.frombuffer(seq.encode(), dtype=np.uint8)
    codes = _ENCODE_LUT[raw]
    if codes.max(initial=0) > 3:
        if not mask_invalid:
            bad = seq[int(np.argmax(codes > 3))]
            raise ValueError(f"non-ACGT character {bad!r} in sequence")
        codes = np.where(codes > 3, np.uint8(INVALID_CODE), codes)
    return codes


def decode_seq(codes: np.ndarray) -> str:
    """uint8 code array -> ACGT string."""
    codes = np.asarray(codes, dtype=np.uint8)
    return _DECODE_LUT[codes].tobytes().decode()


def revcomp_str(seq: str) -> str:
    """Reverse complement of an ACGT string."""
    return decode_seq(3 - encode_seq(seq)[::-1])


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a 2-bit code array (complement == 3 - code)."""
    return (3 - np.asarray(codes, dtype=np.uint8))[::-1]


def canonical_str(kmer: str) -> str:
    """Canonical form: lexicographic min of the k-mer and its revcomp."""
    rc = revcomp_str(kmer)
    return kmer if kmer <= rc else rc


def least_rotation(s: str) -> str:
    """Lexicographically smallest rotation.

    Canonical linearization point for circular contigs: a cycle and its
    reverse complement must map to one representative regardless of where
    each strand's traversal happened to break the cycle.

    Two implementations, same answer: a vectorized candidate-elimination
    tournament (rounds of "keep the starts whose next character is
    minimal" — expected O(n) total work at ~4x candidate shrink per
    round on DNA; periodic inputs are detected by a whole-string
    rotation check and resolved exactly), falling back to the O(n)
    pure-Python Booth loop for short strings and for adversarial
    near-periodic inputs where the tournament exceeds its work budget.
    The r5 motivator: Booth in Python costs ~6 s per strand on a 4.6 Mb
    circular E. coli contig (CFG-5 traverse was 13.5 s of a 24.5 s
    wall); the tournament runs the same input in ~30 ms.
    """
    n = len(s)
    if n > 4096:
        out = _least_rotation_np(s)
        if out is not None:
            return out
    return _least_rotation_booth(s)


def _least_rotation_np(s: str) -> str | None:
    """Vectorized smallest-rotation tournament; None if the work budget
    is exceeded (caller falls back to Booth)."""
    n = len(s)
    a = np.frombuffer(s.encode(), dtype=np.uint8)
    d = np.concatenate([a, a])
    cand = np.flatnonzero(a == a.min())
    if len(cand) == 1:
        i = int(cand[0])
        return s[i:] + s[:i]
    depth = 1
    budget = 32 * n  # total gathered elements before giving up
    spent = len(cand)
    while len(cand) > 1 and depth < n:
        nxt = d[cand + depth]
        m = nxt.min()
        kept = cand[nxt == m]
        spent += len(cand)
        if spent > budget:
            return None
        if len(kept) == len(cand):
            # no elimination: suspect global periodicity — if rotating
            # by the candidate gap maps s to itself AND the candidates
            # already agree on a window >= that period, periodicity
            # makes their rotations globally identical, so the smallest
            # index wins exactly (agreement on >= p consecutive chars
            # of a period-p sequence implies agreement everywhere)
            p = int(kept[1] - kept[0])
            if depth >= p and np.array_equal(d[p : p + n], a):
                cand = kept[:1]
                break
        cand = kept
        depth += 1
    i = int(cand[0])
    return s[i:] + s[:i]


def _least_rotation_booth(s: str) -> str:
    """O(n) Booth's algorithm (pure Python), the normative reference."""
    doubled = s + s
    n = len(doubled)
    f = [-1] * n
    k = 0
    for j in range(1, n):
        sj = doubled[j]
        i = f[j - k - 1]
        while i != -1 and sj != doubled[k + i + 1]:
            if sj < doubled[k + i + 1]:
                k = j - i - 1
            i = f[i]
        if sj != doubled[k + i + 1]:
            if sj < doubled[k]:
                k = j
            f[j - k] = -1
        else:
            f[j - k] = i + 1
    return doubled[k : k + len(s)]


def canonical_cycle(core: str) -> str:
    """Rotation- and strand-invariant representative of a circular sequence."""
    return min(least_rotation(core), least_rotation(revcomp_str(core)))


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """[B, L] 2-bit codes -> [B, ceil(L/4)] uint8, 4 bases per byte.

    Base j lives in byte j//4 at bit 2*(j%4) (little-endian within the
    byte). Used to quarter host->device transfer volume; the device
    unpacks in one elementwise pass (ops.kmer_jax.unpack_codes).

    INVALID_CODE bases don't fit 2 bits; they pack as their low 2 bits and
    must be carried separately via pack_invalid_mask.
    """
    b, length = codes.shape
    pad = (-length) % 4
    if pad:
        codes = np.concatenate(
            [codes, np.zeros((b, pad), dtype=np.uint8)], axis=1
        )
    quads = (codes & np.uint8(3)).reshape(b, -1, 4)
    return (
        quads[:, :, 0]
        | (quads[:, :, 1] << 2)
        | (quads[:, :, 2] << 4)
        | (quads[:, :, 3] << 6)
    )


def pack_invalid_mask(codes: np.ndarray) -> np.ndarray | None:
    """[B, L] codes -> [B, ceil(L/8)] uint8 bitmask of invalid bases.

    Returns None when every base is valid (the common case — callers then
    skip the extra transfer entirely; the mask costs 1 bit/base vs the
    packed reads' 2 bits/base when present).
    """
    bad = codes > 3
    if not bad.any():
        return None
    b, length = codes.shape
    pad = (-length) % 8
    if pad:
        bad = np.concatenate(
            [bad, np.zeros((b, pad), dtype=bool)], axis=1
        )
    return np.packbits(bad, axis=1, bitorder="little")


def unpack_codes_np(packed: np.ndarray, n: int) -> np.ndarray:
    """Flat packed bytes (4 bases/byte, pack_codes bit layout) -> [n] codes.

    Host-side inverse of the flat packing ops.unitig_jax.spell_arrays
    applies to the spelled base stream before it crosses the device->host
    link. Only the first ceil(n/4) bytes are consumed.
    """
    packed = np.asarray(packed[: (n + 3) // 4], dtype=np.uint8)
    quads = np.empty((packed.size, 4), dtype=np.uint8)
    quads[:, 0] = packed & 3
    quads[:, 1] = (packed >> 2) & 3
    quads[:, 2] = (packed >> 4) & 3
    quads[:, 3] = (packed >> 6) & 3
    return quads.reshape(-1)[:n]


def has_ambiguous(codes: np.ndarray) -> bool:
    """True if any code is > 3 (ambiguous/N base) — allocation-free.

    ``(codes > 3).any()`` materializes a full-size boolean temp; at CFG-2
    scale (232 MB of reads) the page faults on that fresh allocation
    measured 4.5 s of host wall on this machine. A chunked ``max`` scans
    at memory bandwidth with zero allocations and exits early once an
    ambiguous code is seen (real data usually shows its first N early).
    """
    flat = np.asarray(codes).ravel()
    step = 1 << 24
    for i in range(0, flat.size, step):
        if flat[i : i + step].max(initial=0) > 3:
            return True
    return False


def key_words(k: int) -> int:
    """Number of uint32 words per k-mer key.

    ``2k // 32 + 1`` guarantees >= 2 spare zero bits in the top word for every
    valid k-mer, reserving the all-ones tuple as the invalid/+inf sentinel.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return 2 * k // 32 + 1


def kmer_to_words(codes: np.ndarray) -> tuple[int, ...]:
    """Pack k 2-bit codes into the big-endian uint32 word tuple.

    Host-side mirror of the packing the Pallas extraction kernel performs;
    used as the oracle for kernel unit tests.
    """
    codes = np.asarray(codes, dtype=np.uint64)
    k = len(codes)
    w = key_words(k)
    value = 0
    for c in codes:
        value = (value << 2) | int(c)
    words = []
    for i in range(w):
        shift = 32 * (w - 1 - i)
        words.append((value >> shift) & 0xFFFFFFFF)
    return tuple(words)


def words_to_kmer(words: tuple[int, ...], k: int) -> str:
    """Inverse of :func:`kmer_to_words` (for debugging/tests)."""
    value = 0
    for word in words:
        value = (value << 32) | int(word)
    codes = [(value >> (2 * (k - 1 - j))) & 3 for j in range(k)]
    return decode_seq(np.array(codes, dtype=np.uint8))
