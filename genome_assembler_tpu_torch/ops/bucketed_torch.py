"""Hash-bucketed running count table for the streaming merge.

Counterpart of ``genome_assembler_tpu/ops/bucketed.py``. The running table
is kept partitioned into ``nb`` hash buckets of ``cb`` rows, so every merge
is a batched sort along the bucket rows ([nb, cb + S] keys,
``torch.sort(dim=1, stable=True)``) instead of one sort of cap + batch rows:

  * bucket(key) = the top bits of a multiplicative mix of the key's uint32
    words (the reference's ``_mix_words``, taken over the same words), so
    every key falls into the same bucket as in the reference, a key's
    bucket never changes, and equal keys always meet in one bucket;
  * a batch is routed by one stable sort of its bucket ids and each
    bucket's run is packed into a fixed [nb, m] segment;
  * the per-bucket merge and run-length reduce are the batched mirror of
    ``count_torch.merge_raw_keys`` (neighbouring differences of the
    exclusive weight cumsum at the run starts);
  * ``flatten_bucketed`` sorts once at the end of a stream into the flat
    compact-front table, bit-identical to the flat streaming path's.

Every bucket stays sorted and compact-front with sentinel padding, exactly
the reference's layout, because mid-stream checkpoints store it. A bucket
past ``cb`` rows or a batch segment past ``m`` rows sets ``overflow`` (a
checked error, never silent truncation). Keys are the port's int64 limbs
(``utils.keys``): one limb for k <= 31, two for 32 <= k <= 63.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.keys import SENTINEL, is_sentinel, limbs_to_words, words_to_limbs
from .count_torch import CountTable, sort_by_words, take_rows
from .hash_torch import limbs_to_key_words, mul32


class BucketedTable(NamedTuple):
    """Running count table partitioned into hash buckets.

    limbs:  [nb, cb, n_limbs] int64, each bucket sorted and compact-front,
            sentinel padding.
    counts: [nb, cb] int32, 0 on padding rows.
    num_unique: [nb] int64 unique keys a bucket (<= cb).
    overflow: 0-d bool -- a bucket exceeded cb or a batch segment m.
    """

    limbs: torch.Tensor
    counts: torch.Tensor
    num_unique: torch.Tensor
    overflow: torch.Tensor


_MIX_A = 2654435761
_MIX_B = 0x7FEB352D


def _mix_words(words: torch.Tensor) -> torch.Tensor:
    """[N, W] uint32 key words (in int64) -> [N] uint32 hash (in int64): the
    reference's bucket mix (Knuth multiplicative + finalizer)."""
    h = mul32(words[:, 0], _MIX_A)
    for i in range(1, words.shape[1]):
        h = mul32(h ^ words[:, i], _MIX_A)
    h = h ^ (h >> 16)
    h = mul32(h, _MIX_B)
    return h ^ (h >> 15)


def _bucket_of(limbs: torch.Tensor, nb: int) -> torch.Tensor:
    """[N, n_limbs] keys -> [N] int64 bucket in [0, nb) (``nb`` a power of
    two); sentinel rows get nb. The mix is taken over the key's words at
    the widest word count of its limb count (leading zero words leave
    the reference's mix unchanged, so any k of that limb count gives the
    reference's bucket)."""
    words = limbs_to_key_words(limbs, 31 if limbs.shape[1] == 1 else 63)
    b = _mix_words(words) >> (32 - (nb.bit_length() - 1))
    return torch.where(is_sentinel(limbs), nb, b)


def _route_and_pack(keys: torch.Tensor, nb: int, m: int,
                    payload: torch.Tensor | None = None,
                    full_order: bool = True):
    """Sort rows by bucket and pack each bucket's run into [nb, m].

    Returns (packed limbs [nb, m, n_limbs], packed payload [nb, m] or
    None, run lengths [nb], over_m 0-d bool). Padding rows are sentinel
    (payload 0). full_order=True orders each bucket's rows by key (the
    table layout, for ``bucketize``); full_order=False keeps them in batch
    order (one stable sort of the bucket ids only), enough for the merge,
    which sorts every bucket again."""
    dev = keys.device
    if keys.shape[0] == 0:  # a run of nothing: one sentinel row
        keys = torch.full((1, keys.shape[1]), SENTINEL, dtype=torch.int64,
                          device=dev)
        payload = None if payload is None else payload.new_zeros(1)
    if full_order:
        keys, *rest = sort_by_words(keys, *(() if payload is None
                                            else (payload,)))
        payload = rest[0] if rest else None
    bkt_s, order = torch.sort(_bucket_of(keys, nb), stable=True)
    starts = torch.searchsorted(bkt_s, torch.arange(nb + 1, device=dev))
    lens = starts[1:] - starts[:-1]
    over_m = (lens > m).any()
    j = torch.arange(m, device=dev)
    in_run = j[None, :] < lens[:, None]
    src = order[torch.where(in_run, starts[:nb, None] + j[None, :], 0)]
    packed = torch.where(in_run[..., None],
                         take_rows(keys, src.reshape(-1)).reshape(nb, m, -1),
                         SENTINEL)
    if payload is None:
        return packed, None, lens, over_m
    return packed, torch.where(in_run, payload[src], 0), lens, over_m


def _batched_sort(limbs: torch.Tensor, weights: torch.Tensor):
    """Lexicographic sort of every bucket's rows: [nb, R, n_limbs] keys
    and [nb, R] weights, one stable sort along the rows a limb, least
    significant limb first."""
    nl = limbs.shape[2]
    vals, perm = torch.sort(limbs[:, :, nl - 1], dim=1, stable=True)
    for i in range(nl - 2, -1, -1):
        vals, idx = torch.sort(torch.gather(limbs[:, :, i], 1, perm), dim=1,
                               stable=True)
        perm = torch.gather(perm, 1, idx)
    if nl == 1:
        out = vals[:, :, None]
    else:
        out = torch.stack(
            [torch.gather(limbs[:, :, i], 1, perm) for i in range(nl)], dim=2)
    return out, torch.gather(weights, 1, perm)


def _batched_weighted_reduce(limbs: torch.Tensor, weights: torch.Tensor):
    """Per-bucket run-length weighted reduce of [nb, R, n_limbs] keys
    sorted within each bucket, with [nb, R] weights
    (``bucketed._batched_weighted_reduce``). The run starts compact to
    the front of each bucket (a scatter of each to its cumsum slot), and a
    run's weight is the difference of neighbouring exclusive weight
    cumsums; the last run closes at the bucket's total. Returns (unique
    [nb, R, n_limbs] compact-front, counts [nb, R] int32, num_unique [nb]
    int64)."""
    nb, rows, nl = limbs.shape
    dev = limbs.device
    is_start = torch.ones((nb, rows), dtype=torch.bool, device=dev)
    if rows > 1:
        is_start[:, 1:] = (limbs[:, 1:] != limbs[:, :-1]).any(dim=2)
    sent = limbs[:, :, 0] == SENTINEL
    real = is_start & ~sent
    num_u = real.sum(dim=1)
    w = weights.to(torch.int64)
    excl = torch.cumsum(w, dim=1) - w
    total = torch.where(sent, 0, w).sum(dim=1)
    # each run start to its slot in its bucket; the rest to a dump column
    dest = torch.where(real, torch.cumsum(real, dim=1) - 1, rows)
    unique = torch.full((nb, rows + 1, nl), SENTINEL, dtype=torch.int64,
                        device=dev)
    unique.scatter_(1, dest[..., None].expand(nb, rows, nl), limbs)
    excl_c = torch.zeros((nb, rows + 1), dtype=torch.int64, device=dev)
    excl_c.scatter_(1, dest, excl)
    unique, excl_c = unique[:, :rows], excl_c[:, :rows]
    idx = torch.arange(rows, device=dev)[None, :]
    nxt = torch.cat([excl_c[:, 1:], excl_c.new_zeros((nb, 1))], dim=1)
    nxt = torch.where(idx == num_u[:, None] - 1, total[:, None], nxt)
    counts = torch.where(idx < num_u[:, None], nxt - excl_c, 0)
    return unique, counts.to(torch.int32), num_u


def empty_bucketed(nb: int, cb: int, nl: int,
                   device: torch.device | str) -> BucketedTable:
    return BucketedTable(
        limbs=torch.full((nb, cb, nl), SENTINEL, dtype=torch.int64,
                         device=device),
        counts=torch.zeros((nb, cb), dtype=torch.int32, device=device),
        num_unique=torch.zeros(nb, dtype=torch.int64, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


def merge_packed_bucketed(bt: BucketedTable, packed: torch.Tensor,
                          extra_overflow: torch.Tensor | None = None
                          ) -> BucketedTable:
    """Merge pre-routed rows ([nb, S, n_limbs], every row in its key's
    bucket, sentinel rows ignored, any order) into the table: one batched
    [nb, cb + S] weighted sort and reduce. ``extra_overflow`` (a routing
    flag) folds into the table's."""
    nb, cb, _ = bt.limbs.shape
    merged = torch.cat([bt.limbs, packed], dim=1)
    wts = torch.cat([bt.counts, torch.ones(packed.shape[:2], dtype=torch.int32,
                                           device=packed.device)], dim=1)
    unique, counts, num_u = _batched_weighted_reduce(*_batched_sort(merged, wts))
    overflow = bt.overflow | (num_u > cb).any()
    if extra_overflow is not None:
        overflow = overflow | extra_overflow
    return BucketedTable(
        limbs=unique[:, :cb],
        counts=counts[:, :cb],
        num_unique=num_u.clamp(max=cb),
        overflow=overflow,
    )


def route_pack_keys(keys: torch.Tensor, nb: int, m: int):
    """A raw [N, n_limbs] key stream routed into per-bucket segments without
    merging: ([nb, m, n_limbs] packed rows in batch order, over_m)."""
    packed, _, _, over_m = _route_and_pack(keys, nb, m, full_order=False)
    return packed, over_m


def merge_raw_keys_bucketed(bt: BucketedTable, keys: torch.Tensor,
                            m: int) -> BucketedTable:
    """Merge a raw (unsorted, uncounted) key stream into the table: the
    batched mirror of ``count_torch.merge_raw_keys``."""
    packed, over_m = route_pack_keys(keys, bt.limbs.shape[0], m)
    return merge_packed_bucketed(bt, packed, over_m)


def bucketize(table: CountTable, nb: int, cb: int) -> BucketedTable:
    """Partition a flat compact-front CountTable into hash buckets (a
    resumed or resharded stream)."""
    c = table.limbs.shape[0]
    real = torch.arange(c, device=table.limbs.device) < table.num_unique
    limbs = torch.where(real[:, None], table.limbs, SENTINEL)
    counts = torch.where(real, table.counts, 0)
    packed, pay, lens, over = _route_and_pack(limbs, nb, cb, payload=counts)
    return BucketedTable(
        limbs=packed,
        counts=pay.to(torch.int32),
        num_unique=lens.clamp(max=cb),
        overflow=table.overflow | over,
    )


def flatten_bucketed(bt: BucketedTable, capacity: int) -> CountTable:
    """The bucketed table as the flat compact-front sorted CountTable of
    ``capacity`` rows (one sort, once a stream): bit-identical to the flat
    streaming path's table."""
    nb, cb, nl = bt.limbs.shape
    limbs, counts = sort_by_words(bt.limbs.reshape(nb * cb, nl),
                                  bt.counts.reshape(nb * cb))
    num = bt.num_unique.sum()
    if capacity <= nb * cb:
        limbs, counts = limbs[:capacity], counts[:capacity]
    else:
        pad = capacity - nb * cb
        limbs = torch.cat([limbs, limbs.new_full((pad, nl), SENTINEL)])
        counts = torch.cat([counts, counts.new_zeros(pad)])
    return CountTable(
        limbs=limbs,
        counts=counts,
        num_unique=num.clamp(max=capacity),
        overflow=bt.overflow | (num > capacity),
    )


# Target rows a bucket takes into one merge, for the automatic bucket
# count: the reference's value, kept so that both packages pick the same
# geometry (and their checkpoints cross).
BUCKET_TARGET_SEG = 96 * 1024


def auto_buckets(capacity: int, merge_windows: int, accum: int = 1,
                 cb_slack: float = 1.25, m_slack: float = 1.5) -> int:
    """Power-of-two bucket count that puts a merge's rows a bucket
    ((cb_slack * capacity + m_slack * accum * merge_windows) / nb) near
    BUCKET_TARGET_SEG, clamped to [256, 4096] (``bucketed.auto_buckets``)."""
    per_merge = cb_slack * capacity + m_slack * accum * merge_windows
    nb = 256
    while nb < 4096 and per_merge / nb > BUCKET_TARGET_SEG:
        nb *= 2
    return nb


def bucket_geometry(capacity: int, merge_windows: int, *, nb: int,
                    cb_slack: float, m_slack: float) -> tuple[int, int]:
    """(cb, m): rows a bucket holds and rows a bucket takes from one
    batch, each the uniform expectation with slack, rounded up to a
    multiple of 128 (``bucketed.bucket_geometry``)."""

    def up128(x: int) -> int:
        return -(-x // 128) * 128

    cb = up128(int(-(-capacity * cb_slack // nb)))
    m = up128(int(-(-merge_windows * m_slack // nb)))
    return cb, m


def bucketed_to_numpy(bt: BucketedTable, k: int):
    """The table in the reference's checkpoint layout: (words [nb, cb, W]
    uint32, counts [nb, cb] int32, num_unique [nb] int32, overflow bool)."""
    nb, cb, nl = bt.limbs.shape
    words = limbs_to_words(bt.limbs.reshape(nb * cb, nl).cpu().numpy(), k)
    return (
        words.reshape(nb, cb, -1),
        bt.counts.cpu().numpy().astype(np.int32),
        bt.num_unique.cpu().numpy().astype(np.int32),
        np.bool_(bool(bt.overflow)),
    )


def bucketed_from_numpy(words: np.ndarray, counts: np.ndarray, num_unique,
                        overflow, device: torch.device | str = "cpu"
                        ) -> BucketedTable:
    """A table in the reference's layout (``bucketed_to_numpy``'s arrays)
    -> the port's table on ``device``."""
    nb, cb, w = words.shape
    limbs = words_to_limbs(np.asarray(words).reshape(nb * cb, w))
    return BucketedTable(
        limbs=torch.from_numpy(limbs.reshape(nb, cb, -1)).to(device),
        counts=torch.from_numpy(
            np.asarray(counts, dtype=np.int32).copy()).to(device),
        num_unique=torch.from_numpy(
            np.asarray(num_unique, dtype=np.int64).copy()).to(device),
        overflow=torch.tensor(bool(overflow), device=device),
    )
