"""Sort/segment-reduce k-mer counting on limb keys.

Counterpart of ``genome_assembler_tpu/ops/count_jax.py``. Outputs equal
the reference bit for bit up to ``num_unique`` (keys, counts,
``num_unique``, ``overflow``); padding rows are sentinel keys with count
0. Everything stays on the tensors' device: ``num_unique`` and
``overflow`` are 0-d tensors, and only the host-driven ``compact_table``
reads one back.

The reference avoids scatters because they serialize on the TPU; that is
a constraint of the TPU, not of the algorithm, so compaction here is a
scatter of each kept row to its exclusive-cumsum slot (unique targets;
dropped rows all land in one discard row past the end).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.keys import SENTINEL, is_sentinel, limbs_to_words, snug_capacity
from ..utils.keys import words_to_limbs


class CountTable(NamedTuple):
    """Sorted unique canonical k-mers + multiplicities (capacity-bounded).

    limbs:  [C, n_limbs] int64, lexicographically sorted; sentinel padding.
    counts: [C] int32, 0 on padding rows.
    num_unique: 0-d int64 tensor (<= C).
    overflow: 0-d bool tensor -- a count or merge exceeded capacity C and
        entries were dropped (a checked error, never silent).
    """

    limbs: torch.Tensor
    counts: torch.Tensor
    num_unique: torch.Tensor
    overflow: torch.Tensor


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for a 1-D index. Rows of a multiple of 16 bytes (two
    int64 limbs, an (id, id) pair) gather through a flat index instead:
    torch's row gather of such rows is slow on CUDA (12.6M random 16-byte
    rows: 7.59 ms against 0.64 ms flat on an H100, PERF.md)."""
    if x.dim() != 2 or x.shape[1] * x.element_size() % 16:
        return x[idx]
    c = x.shape[1]
    flat = idx[:, None] * c + torch.arange(c, device=x.device)
    return x.reshape(-1)[flat]


def sort_by_words(
    limbs: torch.Tensor, *payloads: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """Lexicographic sort of [N, n_limbs] keys (+ payload columns): one
    stable ``torch.sort`` per limb, least significant limb first."""
    nl = limbs.shape[1]
    vals, perm = torch.sort(limbs[:, nl - 1], stable=True)
    for i in range(nl - 2, -1, -1):
        vals, idx = torch.sort(limbs[perm, i], stable=True)
        perm = perm[idx]
    out = vals[:, None] if nl == 1 else take_rows(limbs, perm)
    return (out,) + tuple(p[perm] for p in payloads)


def compact_front_sorted(
    keep: torch.Tensor, col: torch.Tensor, fill: int
) -> torch.Tensor:
    """Rows of ``col`` where ``keep``, in their order, at the front;
    ``fill`` behind them; same length as ``col``. Counterpart of
    ``count_jax.compact_front_sorted`` (which re-sorts masked keys; here
    each kept row scatters to its exclusive-cumsum slot)."""
    n = keep.shape[0]
    dest = torch.where(keep, torch.cumsum(keep, 0) - 1, n)
    out = torch.full(
        (n + 1,) + tuple(col.shape[1:]), fill, dtype=col.dtype, device=col.device
    )
    out[dest] = col
    return out[:n]


def _segment_reduce(
    limbs_sorted: torch.Tensor, weights: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run-length reduce of sorted keys (``count_jax._segment_reduce``).

    Group starts are rows that differ from their predecessor; the start
    rows compact to the front, and each group's count is the difference
    of neighbouring start positions (unweighted) or of the exclusive
    weight cumsum at the starts (weighted); the last real group closes at
    the total valid weight. Returns (unique [N, n_limbs], counts [N]
    int32, num_unique 0-d int64).
    """
    n = limbs_sorted.shape[0]
    dev = limbs_sorted.device
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        is_start[1:] = (limbs_sorted[1:] != limbs_sorted[:-1]).any(dim=1)
    sent = is_sentinel(limbs_sorted)
    real_start = is_start & ~sent
    num_unique = real_start.sum()
    unique = compact_front_sorted(real_start, limbs_sorted, SENTINEL)
    if weights is None:
        excl = torch.arange(n, dtype=torch.int64, device=dev)
        total = (~sent).sum()
    else:
        w = weights.to(torch.int64)
        excl = torch.cumsum(w, 0) - w
        total = torch.where(sent, 0, w).sum()
    excl_c = compact_front_sorted(real_start, excl, 0)
    idx = torch.arange(n, device=dev)
    nxt = torch.cat([excl_c[1:], excl_c.new_zeros(1)])
    nxt = torch.where(idx == num_unique - 1, total, nxt)
    counts = torch.where(idx < num_unique, nxt - excl_c, 0).to(torch.int32)
    return unique, counts, num_unique


def count_keys(
    keys: torch.Tensor, weights: torch.Tensor | None = None
) -> CountTable:
    """[N, n_limbs] canonical keys (sentinel = invalid) -> CountTable of
    capacity N."""
    if weights is None:
        (limbs_sorted,) = sort_by_words(keys)
        unique, counts, num = _segment_reduce(limbs_sorted, None)
    else:
        limbs_sorted, w_sorted = sort_by_words(keys, weights)
        unique, counts, num = _segment_reduce(limbs_sorted, w_sorted)
    return CountTable(
        limbs=unique,
        counts=counts,
        num_unique=num,
        overflow=torch.zeros((), dtype=torch.bool, device=keys.device),
    )


def empty_table(
    capacity: int, nl: int, device: torch.device | str
) -> CountTable:
    return CountTable(
        limbs=torch.full((capacity, nl), SENTINEL, dtype=torch.int64,
                         device=device),
        counts=torch.zeros(capacity, dtype=torch.int32, device=device),
        num_unique=torch.zeros((), dtype=torch.int64, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


def resize_table(table: CountTable, cap: int) -> CountTable:
    """Truncate (flagging overflow if real rows are dropped) or pad with
    sentinel rows to exactly ``cap`` rows."""
    c = table.limbs.shape[0]
    if cap < c:
        return CountTable(
            limbs=table.limbs[:cap],
            counts=table.counts[:cap],
            num_unique=torch.clamp(table.num_unique, max=cap),
            overflow=table.overflow | (table.num_unique > cap),
        )
    if cap > c:
        pad = empty_table(cap - c, table.limbs.shape[1], table.limbs.device)
        return CountTable(
            limbs=torch.cat([table.limbs, pad.limbs]),
            counts=torch.cat([table.counts, pad.counts]),
            num_unique=table.num_unique,
            overflow=table.overflow,
        )
    return table


def merge_raw_keys(table: CountTable, keys: torch.Tensor) -> CountTable:
    """Merge a raw (unsorted, uncounted) key stream into the running table:
    table rows weigh their counts, stream rows weigh 1, sentinel rows are
    excluded by the reduce. Result capacity == table capacity."""
    cap = table.limbs.shape[0]
    limbs = torch.cat([table.limbs, keys])
    weights = torch.cat([
        table.counts,
        torch.ones(keys.shape[0], dtype=torch.int32, device=keys.device),
    ])
    limbs_sorted, w_sorted = sort_by_words(limbs, weights)
    unique, counts, num = _segment_reduce(limbs_sorted, w_sorted)
    return CountTable(
        limbs=unique[:cap],
        counts=counts[:cap],
        num_unique=torch.clamp(num, max=cap),
        overflow=table.overflow | (num > cap),
    )


def multiplicity_histogram(table: CountTable) -> torch.Tensor:
    """[1001] int32 histogram of min(count, 1000) over the rows below
    ``num_unique`` (the input of ``auto_min_count``); rows past it go to
    an out-of-range bin that is dropped, as in the reference."""
    n = table.counts.shape[0]
    lane = torch.arange(n, device=table.counts.device)
    c = torch.where(
        lane < table.num_unique,
        torch.clamp(table.counts.to(torch.int64), max=1000),
        1001,
    )
    return torch.bincount(c, minlength=1002)[:1001].to(torch.int32)


def compact_table(table: CountTable) -> CountTable:
    """Slice a compact-front table down to a snug capacity (one scalar
    read back to the host). No-op when already snug."""
    num = int(table.num_unique)
    cap = snug_capacity(num, fine=True)
    if cap >= table.limbs.shape[0]:
        return table
    return CountTable(
        limbs=table.limbs[:cap],
        counts=table.counts[:cap],
        num_unique=table.num_unique,
        overflow=table.overflow,
    )


def filter_table(table: CountTable, min_count: int) -> CountTable:
    """Coverage filter: drop counts < min_count and recompact (survivors
    stay sorted at the front). min_count <= 1 is an exact no-op."""
    if min_count <= 1:
        return table
    keep = table.counts >= min_count
    return CountTable(
        limbs=compact_front_sorted(keep, table.limbs, SENTINEL),
        counts=compact_front_sorted(keep, table.counts, 0),
        num_unique=keep.sum(),
        overflow=table.overflow,
    )


def count_table_from_numpy(
    words: np.ndarray,
    counts: np.ndarray,
    num_unique,
    overflow,
    device: torch.device | str = "cpu",
) -> CountTable:
    """A reference ``CountTable`` as numpy arrays ([C, W] uint32 words,
    [C] counts, scalars) -> the port's table on ``device``."""
    return CountTable(
        limbs=torch.from_numpy(words_to_limbs(words)).to(device),
        counts=torch.from_numpy(
            np.asarray(counts, dtype=np.int32).copy()
        ).to(device),
        num_unique=torch.tensor(int(num_unique), dtype=torch.int64,
                                device=device),
        overflow=torch.tensor(bool(overflow), device=device),
    )


def count_table_to_numpy(
    table: CountTable, k: int
) -> tuple[np.ndarray, np.ndarray, np.int32, np.bool_]:
    """The port's table -> reference layout (words [C, W] uint32, counts
    [C] int32, num_unique int32, overflow bool) as numpy."""
    return (
        limbs_to_words(table.limbs.cpu().numpy(), k),
        table.counts.cpu().numpy().astype(np.int32),
        np.int32(int(table.num_unique)),
        np.bool_(bool(table.overflow)),
    )
