"""Mixing hash for owner routing, on int64 tensors.

Counterpart of ``genome_assembler_tpu/ops/hash.py`` (``mix_words``,
``mix32``). The reference hashes the key's big-endian uint32 word layout
(``utils.dna.key_words``: 1 to 4 words) with uint32 wrap-around
arithmetic; the owner of a key is ``mix % D``. The port keeps keys as
int64 limbs (``utils.keys``), so the words are rebuilt from the limbs on
the device first (``limbs_to_key_words``), and every uint32 value lives
in the low 32 bits of an int64 lane.

A 32x32-bit product does not fit in int64, so every multiply splits one
factor into 16-bit halves: ``a * b mod 2^32 = (a_lo * b + ((a_hi * b)
mod 2^16) << 16) mod 2^32``. Each partial product stays below 2^48, so
no intermediate value reaches 2^63 and nothing relies on signed
overflow.
"""

from __future__ import annotations

import torch

from genome_assembler_tpu.utils.dna import key_words

from ..utils.keys import lsr, to_raw

_P1 = 0x9E3779B1
_P2 = 0x85EBCA77
_P3 = 0xC2B2AE3D
_P4 = 0x27D4EB2F
_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2^32`` for uint32 values held in int64 (``b`` a uint32
    constant); every intermediate stays below 2^49."""
    lo = (a & _M16) * b
    hi = ((a >> 16) * b) & _M16
    return (lo + (hi << 16)) & _M32


def mix_words(words: torch.Tensor) -> torch.Tensor:
    """[..., W] uint32 key words (in int64) -> [...] uint32 hash (in int64),
    equal to the reference ``mix_words`` on the same words."""
    w = words.shape[-1]
    h = mul32(words[..., 0], _P1)
    for i in range(1, w):
        h = mul32(h ^ mul32(words[..., i], _P2), _P3)
    h = h ^ (h >> 15)
    h = mul32(h, _P4)
    h = h ^ (h >> 13)
    h = mul32(h, _P2)
    return h ^ (h >> 16)


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Single-word mix (the w=1 case of :func:`mix_words`)."""
    return mix_words(x[..., None])


def limbs_to_key_words(limbs: torch.Tensor, k: int) -> torch.Tensor:
    """[N, n_limbs] limbs -> [N, key_words(k)] uint32 words in int64, on the
    limbs' device (the sign flip of a low limb undone first). Sentinel
    rows give words that are not the reference's all-ones sentinel;
    callers mask them, as routing does."""
    w = key_words(k)
    raw = to_raw(limbs)
    lo = raw[-1]
    hi = raw[0] if len(raw) == 2 else None
    words = []
    for i in range(w):
        shift = 32 * (w - 1 - i)
        src, s = (lo, shift) if shift < 64 else (hi, shift - 64)
        words.append(lsr(src, s) & _M32)
    return torch.stack(words, dim=-1)


def owner_of(limbs: torch.Tensor, k: int, d: int) -> torch.Tensor:
    """[N] int64 owner shard ``mix_words(key words) % d`` of each key."""
    return mix_words(limbs_to_key_words(limbs, k)) % d
