"""k-mer keys as int64 limbs.

The reference keeps a k-mer as ``W = 2k//32 + 1`` big-endian uint32 words
(``genome_assembler_tpu.utils.dna.key_words``) with the all-ones tuple as
the +inf sentinel. torch's ``uint32`` has no shifts, compares, add or
``minimum`` on the CPU, so the port carries keys as int64 limbs whose
*signed* lexicographic order equals the unsigned order of the 2k-bit key:

  * k <= 31 (W <= 2): one limb, the key value itself. Real keys are below
    2^62; the sentinel is ``INT64_MAX``.
  * 32 <= k <= 63 (W 3..4): two limbs, (high 64 bits, low 64 bits) of the
    128-bit value. The high limb of a real key is below 2^62; the low
    limb has its sign bit flipped (``lo ^ INT64_MIN``) so that signed
    order equals unsigned order. The sentinel is ``INT64_MAX`` in both.

Bit arithmetic (shifts, reverse complement) runs on the *raw* form: the
plain unsigned bits held in int64 tensors (``to_raw`` / ``from_raw``);
only sorting and comparing use the limb form.
"""

from __future__ import annotations

import numpy as np
import torch

from .dna import key_words

INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)
SENTINEL = INT64_MAX
# real high limbs (and one-limb keys) stay below this
_REAL_BOUND = 1 << 62
_WORD_SENT = np.uint32(0xFFFFFFFF)


def n_limbs(k: int) -> int:
    """Limbs per key: 1 for k <= 31, 2 for 32 <= k <= 63."""
    if not 1 <= k <= 63:
        raise ValueError(f"k must be in [1, 63], got {k}")
    return 1 if k <= 31 else 2


def _limbs_for_words(w: int) -> int:
    if not 1 <= w <= 4:
        raise ValueError(f"key word count must be in [1, 4], got {w}")
    return 1 if w <= 2 else 2


def words_to_limbs(words: np.ndarray) -> np.ndarray:
    """[N, W] uint32 reference keys -> [N, n_limbs] int64 limbs.

    All-ones rows map to the sentinel limbs. Raises ValueError for a
    non-sentinel row whose value does not fit the layout (a key wider
    than 2k <= 126 bits cannot come from any valid k).
    """
    words = np.asarray(words, dtype=np.uint32)
    n, w = words.shape
    nl = _limbs_for_words(w)
    sent = np.all(words == _WORD_SENT, axis=1)
    u = words.astype(np.uint64)
    lo = np.zeros(n, np.uint64)
    hi = np.zeros(n, np.uint64)
    # bottom-up: word W-1 is bits 0..31, word W-2 bits 32..63, ...
    for i in range(w):
        shift = 32 * (w - 1 - i)
        if shift < 64:
            lo |= u[:, i] << np.uint64(shift)
        else:
            hi |= u[:, i] << np.uint64(shift - 64)
    top = lo if nl == 1 else hi
    if np.any(top[~sent] >= np.uint64(_REAL_BOUND)):
        raise ValueError("key words exceed the 2k-bit layout")
    out = np.empty((n, nl), np.int64)
    if nl == 1:
        out[:, 0] = lo.view(np.int64)
    else:
        out[:, 0] = hi.view(np.int64)
        out[:, 1] = (lo ^ np.uint64(1 << 63)).view(np.int64)
    out[sent] = SENTINEL
    return out


def limbs_to_words(limbs: np.ndarray, k: int) -> np.ndarray:
    """[N, n_limbs] int64 limbs -> [N, key_words(k)] uint32 reference keys
    (sentinel rows -> all-ones words)."""
    limbs = np.asarray(limbs, dtype=np.int64)
    w = key_words(k)
    nl = limbs.shape[1]
    if nl != _limbs_for_words(w):
        raise ValueError(f"{nl} limb(s) do not match k={k} (W={w})")
    sent = limbs[:, 0] == SENTINEL
    if nl == 1:
        lo = limbs[:, 0].view(np.uint64)
        hi = np.zeros_like(lo)
    else:
        hi = limbs[:, 0].view(np.uint64)
        lo = limbs[:, 1].view(np.uint64) ^ np.uint64(1 << 63)
    out = np.empty((limbs.shape[0], w), np.uint32)
    mask = np.uint64(0xFFFFFFFF)
    for i in range(w):
        shift = 32 * (w - 1 - i)
        src, s = (lo, shift) if shift < 64 else (hi, shift - 64)
        out[:, i] = ((src >> np.uint64(s)) & mask).astype(np.uint32)
    out[sent] = _WORD_SENT
    return out


def to_raw(limbs: torch.Tensor) -> list[torch.Tensor]:
    """[N, n_limbs] limbs -> raw unsigned bit columns, most significant
    first (the low limb's sign flip undone)."""
    cols = [limbs[:, i] for i in range(limbs.shape[1])]
    if len(cols) == 2:
        cols[1] = cols[1] ^ INT64_MIN
    return cols


def from_raw(cols: list[torch.Tensor]) -> torch.Tensor:
    """Inverse of :func:`to_raw` (does not touch the sentinel: callers
    mask sentinel rows themselves)."""
    cols = list(cols)
    if len(cols) == 2:
        cols[1] = cols[1] ^ INT64_MIN
    return torch.stack(cols, dim=1)


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by 0 <= s < 64 (torch's
    ``>>`` on int64 is arithmetic)."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def is_sentinel(limbs: torch.Tensor) -> torch.Tensor:
    """[N] bool: row is the sentinel (a real high limb is < 2^62, so the
    first limb decides)."""
    return limbs[:, 0] == SENTINEL


def snug_capacity(n: int, floor: int = 1 << 16, fine: bool = False) -> int:
    """Smallest grid capacity >= n, grid = {1, 1.25, 1.5, 1.75} x 2^k
    (fine=True: 1/16 steps). Same grid as the reference's
    ``ops.count_jax.snug_capacity``, so both packages size their tables
    identically."""
    if n <= floor:
        return floor
    p = 1 << (n - 1).bit_length() - 1  # largest power of two < n (n > 1)
    denom, nums = (16, range(17, 33)) if fine else (4, (5, 6, 7, 8))
    for num in nums:
        if n <= p * num // denom:
            return p * num // denom
    return 2 * p
