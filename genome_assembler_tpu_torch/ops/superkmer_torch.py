"""Minimizer super-k-mers: compress the routed k-mer stream.

Counterpart of ``genome_assembler_tpu/ops/superkmer.py``. Routing by the
window's minimizer (the smallest canonical m-mer inside it, by hash) lets
one record carry a run of up to ``RUN_CAP`` consecutive windows as a
2-bit-packed substring, instead of one key per window. A k-mer's
minimizer is a strand-symmetric function of the k-mer alone, so every
occurrence of a canonical k-mer still routes to one owner.

Every uint32 quantity of the reference (m-mer codes, hashes, substring
words) lives in the low 32 bits of an int64 lane here; shifts left are
masked back to 32 bits where they could carry past them. Re-extraction
on the owner rebuilds each window from the substring words with a
word-array shifter (the substring is ``span_words(k)`` words, wider than
a key) and returns keys as int64 limbs (``utils.keys``).

On the wire a record is ``span_words(k) + 1`` int32 columns (substring
words, then the run length) as bit patterns (``to_int32_bits``): with
int64 columns the routed volume would double.
"""

from __future__ import annotations

import torch

from ..utils.keys import SENTINEL, from_raw, n_limbs
from .hash_torch import mix32
from .words_torch import revcomp_words

# windows per super-k-mer record (split point for longer runs); the
# reference's value, so both packages cut the same records
RUN_CAP = 17
_M32 = 0xFFFFFFFF


def span_words(k: int) -> int:
    """uint32 words per packed substring (RUN_CAP + k - 1 bases)."""
    return (2 * (RUN_CAP + k - 1) + 31) // 32


def mean_run(k: int, m: int) -> float:
    """Expected windows per super-k-mer for random sequence, ~(k-m+2)/2,
    capped by RUN_CAP and discounted for variance (capacity sizing)."""
    return max(1.0, min((k - m + 2) / 2, RUN_CAP) * 0.7)


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 -> int32 with the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def from_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_int32_bits`."""
    return x.to(torch.int64) & _M32


def _canonical_mmer_hash(codes: torch.Tensor, m: int) -> torch.Tensor:
    """[B, L] codes -> [B, L-m+1] mixed hash of each canonical m-mer."""
    if not 1 <= m <= 16:
        raise ValueError(f"minimizer length must be in [1, 16], got {m}")
    b, length = codes.shape
    mc = length - m + 1
    fwd = torch.zeros((b, mc), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(m):
        base = codes[:, j : j + mc].to(torch.int64) & 3
        fwd = ((fwd << 2) | base) & _M32
        rc = (rc >> 2) | ((3 - base) << (2 * (m - 1)))
    return mix32(torch.minimum(fwd, rc))


def window_minimizers(
    codes: torch.Tensor, k: int, m: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per k-window minimizer over [B, L] codes.

    Returns (hmin [B, WC] -- the minimizer's hash, the routing key;
    mpos [B, WC] -- its absolute position, leftmost on ties), both int64.
    """
    if m > k:
        raise ValueError(f"minimizer length m={m} must be <= k={k}")
    b, length = codes.shape
    wc = length - k + 1
    hm = _canonical_mmer_hash(codes, m)
    hmin = hm[:, :wc]
    rel = torch.zeros((b, wc), dtype=torch.int64, device=codes.device)
    for j in range(1, k - m + 1):
        h = hm[:, j : j + wc]
        # strict < keeps the earlier (leftmost) position on hash ties
        take = h < hmin
        hmin = torch.where(take, h, hmin)
        rel = torch.where(take, j, rel)
    mpos = rel + torch.arange(wc, device=codes.device)
    return hmin, mpos


def superkmer_records(
    codes: torch.Tensor,
    k: int,
    hmin: torch.Tensor,
    mpos: torch.Tensor,
    window_valid: torch.Tensor,
):
    """Cut reads into super-k-mer records at minimizer/RUN_CAP boundaries.

    Returns, per window position (only ``is_start`` lanes are records):
    is_start [B, WC] bool, run [B, WC] int64 (windows in the record),
    sub [B, WC, SW] int64 uint32 words (big-endian 2-bit substring of
    RUN_CAP + k - 1 bases from this window on, first base topmost), and
    hmin, the owner key.
    """
    b, length = codes.shape
    wc = length - k + 1
    sw = span_words(k)
    dev = codes.device
    widx = torch.arange(wc, device=dev).expand(b, wc)

    prev_pos = torch.cat(
        [torch.full((b, 1), -1, dtype=mpos.dtype, device=dev), mpos[:, :-1]],
        dim=1,
    )
    prev_valid = torch.cat(
        [torch.zeros((b, 1), dtype=torch.bool, device=dev),
         window_valid[:, :-1]],
        dim=1,
    )
    brk = window_valid & ((mpos != prev_pos) | ~prev_valid)
    # split long runs: a break every RUN_CAP windows past the last real
    # break (positions stay deterministic; runs never exceed RUN_CAP)
    last_brk = torch.cummax(torch.where(brk, widx, -1), dim=1).values
    pos_in_run = widx - last_brk
    brk = brk | (window_valid & (pos_in_run % RUN_CAP == 0) & (pos_in_run > 0))

    # run length per start: next break (or first invalid window) after me
    stop = brk | ~window_valid
    nxt = torch.cat(
        [torch.where(stop, widx, wc)[:, 1:],
         torch.full((b, 1), wc, dtype=torch.int64, device=dev)],
        dim=1,
    )
    next_stop = torch.flip(
        torch.cummin(torch.flip(nxt, dims=[1]), dim=1).values, dims=[1]
    )
    run = torch.where(brk, torch.clamp(next_stop - widx, max=RUN_CAP), 0)

    # substring words for every position: positions past the read end pad
    # with zeros (re-extraction masks by run)
    span = RUN_CAP + k - 1
    padded = torch.cat(
        [codes.to(torch.int64) & 3,
         torch.zeros((b, span), dtype=torch.int64, device=dev)],
        dim=1,
    )
    words = [torch.zeros((b, wc), dtype=torch.int64, device=dev)
             for _ in range(sw)]
    total_bits = 32 * sw
    for j in range(span):
        bitpos = total_bits - 2 * (j + 1)  # top-aligned
        wi = sw - 1 - bitpos // 32
        words[wi] = words[wi] | (padded[:, j : j + wc] << (bitpos % 32))
    sub = torch.stack(words, dim=-1)
    return brk, run, sub, hmin


def _shift_right_words32(cols: list[torch.Tensor], bits: int):
    """Logical right shift of a big-endian register of uint32 words (each
    in an int64 column, most significant first) by ``bits``."""
    q, r = divmod(bits, 32)
    out = []
    for i in range(len(cols)):
        src = i - q
        if src < 0:
            out.append(torch.zeros_like(cols[0]))
            continue
        v = cols[src] >> r
        if r and src >= 1:
            v = v | ((cols[src - 1] << (32 - r)) & _M32)
        out.append(v)
    return out


def extract_from_records(
    sub: torch.Tensor, run: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Owner side: [N, SW] substring words (uint32 in int64) + [N] run ->
    ([N * RUN_CAP, n_limbs] canonical limbs, sentinel on lanes past each
    record's run; [N * RUN_CAP] valid)."""
    n, sw = sub.shape
    nl = n_limbs(k)
    cols = [sub[:, i] for i in range(sw)]
    zero = torch.zeros_like(cols[0])

    def word(ws, i):
        return ws[i] if i >= 0 else zero

    keys = []
    for j in range(RUN_CAP):
        # window j = bases j .. j+k-1 = bits [2j, 2j+2k) from the top
        ws = _shift_right_words32(cols, 32 * sw - 2 * (j + k))
        low = (word(ws, sw - 2) << 32) | word(ws, sw - 1)
        if nl == 1:
            raw = [low & ((1 << (2 * k)) - 1)]
        else:
            high = (word(ws, sw - 4) << 32) | word(ws, sw - 3)
            raw = [high & ((1 << (2 * k - 64)) - 1), low]
        fwd = from_raw(raw)
        rc = revcomp_words(fwd, k)
        if nl == 1:
            canon = torch.minimum(fwd, rc)
        else:
            pick_fwd = (fwd[:, 0] < rc[:, 0]) | (
                (fwd[:, 0] == rc[:, 0]) & (fwd[:, 1] <= rc[:, 1])
            )
            canon = torch.where(pick_fwd[:, None], fwd, rc)
        keys.append(canon)
    keys = torch.stack(keys, dim=1)  # [N, RUN_CAP, nl]
    lane = torch.arange(RUN_CAP, device=sub.device)
    valid = lane[None, :] < run[:, None]
    keys = keys.masked_fill(~valid[..., None], SENTINEL)
    return keys.reshape(n * RUN_CAP, nl), valid.reshape(n * RUN_CAP)

