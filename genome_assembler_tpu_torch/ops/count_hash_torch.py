"""The streamed count's hash table on the card.

On a CUDA device a streamed count of one-limb keys (k <= 31) carries its
table as an open-addressing hash table (``ops/stream_table.py``): each
batch's keys go in at once, and the table is sorted into the compact-front
``CountTable`` only when the stream ends or a checkpoint is taken. The JAX
package merges every batch by a sort instead, because its TPU has no fast
data-dependent placement; the tables are equal.

  * ``HashCounts`` -- the table: [slots, 2] int64 rows (the key, SENTINEL
    where empty; the count in the low 32 bits), its claimed slots and its
    overflow flag, all on one device.
  * ``count_insert`` -- the wrapper. A CUDA tensor launches
    ``count_insert_kernel`` (``csrc/kmer_extract.cu``) on the current
    stream (counted in ``count_insert.launches``) or raises; a CPU tensor
    runs the plain version, ``count_insert_ref``.
  * ``hash_to_table`` -- the occupied slots, sorted, padded to the
    capacity: the table a flat sort merge of the same keys gives.

``slots`` is the next power of two at or above twice the capacity, so
while the unique keys stay within the capacity the table is at most half
full. Past the capacity the table flags overflow and still holds every
key until its slots run out: its first ``capacity`` rows are then the
smallest keys with their full counts, as the flat merge keeps them. Past
the slots only the flag is kept.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.keys import SENTINEL
from .count_torch import CountTable


class HashCounts(NamedTuple):
    """An open-addressing table of (key, count) slots on one device."""

    slots: torch.Tensor  # [S, 2] int64: key (SENTINEL empty), count
    claimed: torch.Tensor  # 0-d int64: slots claimed (the unique keys)
    overflow: torch.Tensor  # 0-d int32: unique keys passed the capacity
    capacity: int  # rows of the table it stands for


def hash_slots(capacity: int) -> int:
    """Slots of the hash table for ``capacity`` rows: the next power of
    two at or above twice the capacity."""
    return 1 << (max(1, 2 * capacity) - 1).bit_length()


def empty_hash(capacity: int, device: torch.device | str) -> HashCounts:
    slots = torch.full((hash_slots(capacity), 2), SENTINEL, dtype=torch.int64,
                       device=device)
    slots[:, 1] = 0
    return HashCounts(
        slots=slots,
        claimed=torch.zeros((), dtype=torch.int64, device=device),
        overflow=torch.zeros((), dtype=torch.int32, device=device),
        capacity=capacity,
    )


def slot_hash(keys: torch.Tensor) -> torch.Tensor:
    """[N] int64 keys -> splitmix64's finalizer of each, as int64 bits
    (the kernel's ``fmix64``; a key's probe starts at it masked to the
    slots)."""
    z = keys.cpu().numpy().view(np.uint64)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return torch.from_numpy(z.view(np.int64)).to(keys.device)


def count_insert_ref(ht: HashCounts, keys: torch.Tensor,
                     weights: torch.Tensor | None = None) -> None:
    """The plain version of ``count_insert``: linear probing in rounds.
    Each round every pending row reads its slot; an empty slot goes to
    the first row that reaches it; a row whose slot holds its key adds its
    weight and leaves; the others step on. A row that has walked every
    slot finds the table full and sets the flag."""
    table_keys, table_counts = ht.slots[:, 0], ht.slots[:, 1]
    mask = ht.slots.shape[0] - 1
    key = keys.reshape(-1)
    w = (torch.ones_like(key) if weights is None
         else weights.to(torch.int64))
    live = key != SENTINEL
    key, w = key[live], w[live]
    pos = slot_hash(key) & mask
    steps = 0
    while key.numel():
        cur = table_keys[pos]
        empty = cur == SENTINEL
        if bool(empty.any()):
            want = pos[empty]
            free, inv = torch.unique(want, return_inverse=True)
            first = torch.full_like(free, want.numel()).scatter_reduce_(
                0, inv, torch.arange(want.numel(), device=want.device),
                "amin")
            table_keys[free] = key[empty][first]
            ht.claimed.add_(free.numel())
            cur = table_keys[pos]
        hit = cur == key
        table_counts.index_add_(0, pos[hit], w[hit])
        key, w, pos = key[~hit], w[~hit], (pos[~hit] + 1) & mask
        steps += 1
        if key.numel() and steps > mask:
            ht.overflow.fill_(1)
            break
    if int(ht.claimed) > ht.capacity:
        ht.overflow.fill_(1)


def count_insert(ht: HashCounts, keys: torch.Tensor,
                 weights: torch.Tensor | None = None) -> None:
    """Add [N, 1] one-limb keys (sentinel rows skipped) to ``ht`` in
    place, each with its int32 weight (``weights``, [N]) or 1. On a CUDA
    table this launches ``count_insert_kernel`` on the current stream; on
    a CPU table it runs :func:`count_insert_ref`."""
    dev = ht.slots.device
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 1:
        raise ValueError(f"keys must be [N, 1] int64 one-limb keys, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if keys.device != dev:
        raise ValueError(f"keys on {keys.device}, the table on {dev}")
    if weights is not None and (weights.dtype != torch.int32
                                or tuple(weights.shape) != (keys.shape[0],)
                                or weights.device != dev):
        raise ValueError(f"weights must be [{keys.shape[0]}] int32 on {dev}, "
                         f"got {weights.dtype} {tuple(weights.shape)} on "
                         f"{weights.device}")
    if dev.type == "cpu":
        count_insert_ref(ht, keys, weights)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not keys.is_contiguous() or (weights is not None
                                    and not weights.is_contiguous()):
        raise ValueError("keys and weights must be contiguous")
    from ._build import count_insert_fn

    n = keys.shape[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = count_insert_fn()(
            keys.data_ptr(), None if weights is None else weights.data_ptr(),
            n, ht.slots.data_ptr(), ht.slots.shape[0], ht.capacity,
            ht.claimed.data_ptr(), ht.overflow.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"count_insert launch failed: CUDA error {err} "
                           f"({n} keys, {ht.slots.shape[0]} slots)")
    count_insert.launches += 1


count_insert.launches = 0


def hash_to_table(ht: HashCounts) -> CountTable:
    """The table as the flat compact-front sorted ``CountTable`` of
    ``ht.capacity`` rows: the occupied slots gathered (one read of their
    number to the host) and sorted once, the smallest ``capacity`` kept,
    sentinel rows with count 0 behind them."""
    keys = ht.slots[:, 0]
    idx = torch.nonzero(keys != SENTINEL).squeeze(1)
    vals, order = torch.sort(keys[idx])
    cap = ht.capacity
    n = min(cap, vals.shape[0])
    limbs = keys.new_full((cap, 1), SENTINEL)
    limbs[:n, 0] = vals[:n]
    counts = torch.zeros(cap, dtype=torch.int32, device=keys.device)
    counts[:n] = ht.slots[idx[order[:n]], 1].to(torch.int32)
    return CountTable(
        limbs=limbs,
        counts=counts,
        num_unique=ht.claimed.clamp(max=cap),
        overflow=(ht.overflow != 0) | (ht.claimed > cap),
    )


def insert_bound_ms(n: int, weighted: bool = False) -> tuple[float, int]:
    """The least time the card could take to insert ``n`` keys: the key
    stream (8 B a row, 4 more with weights) and one random 32-byte sector
    read and written back a row, over 3.35 TB/s. Returns (ms, bytes)."""
    from ..utils.metrics import HBM_PEAK_BYTES_S

    nbytes = n * (8 + (4 if weighted else 0) + 64)
    return nbytes / HBM_PEAK_BYTES_S * 1e3, nbytes
