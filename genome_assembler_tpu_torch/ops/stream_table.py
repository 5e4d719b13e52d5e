"""The streamed count's carried table and its merge policy.

One ``CarriedTable`` holds one device's running table, or one shard's,
while a stream of batches is counted into it: ``count_reads_device``
(``models/pipeline.py``) keeps one, the sharded stream
(``parallel/pipeline.py``) one a local shard. Each batch's raw canonical
keys go in by ``add``, under one of three policies that ``stream_layout``
fixes for a run (the reference's rule, so both packages pick the same
layout and their mid-stream checkpoints cross):

  * flat: the keys weighted-merge straight into a table padded to the
    capacity (``count_torch.merge_raw_keys``); the first merge of a
    stream counts its keys straight into such a table;
  * bucketed: once one merge passes ``BUCKETED_MIN_MERGE_ROWS`` rows
    (capacity + the rows of one merge) the table lives in hash buckets,
    each batch is only routed into a staging buffer, and the staged
    batches merge every ``BUCKET_ACCUM`` batches (``BucketedStream``);
  * deferred: under a merge stride s > 1 the keys of s batches wait on
    the device in one buffer and merge at once, in either layout
    (bucketed: accumulation 1).

The table is the same under every policy.

On a CUDA device with one-limb keys (k <= 31) none of these merges runs:
the carried table is a hash table (``ops/count_hash_torch.py``), every
batch's keys go in at once by the hand-written insert kernel, and the
table is sorted once, by ``finish`` (or by ``snapshot`` for a checkpoint).
The JAX package sorts because its TPU has no fast data-dependent
placement; the card has fast atomics. The layout and the stride still
decide the checkpoint's params, the cursors at which a checkpoint may be
taken (``at_boundary``) and the snapshot's form, so checkpoints cross
between the packages as before; a bucketed snapshot that would drop keys
of the exact hash table is refused. CPU tensors keep the sort merges (the
plain version the tests hold to the JAX package), and so do two-limb keys
on the card, which no benchmark cell runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.keys import SENTINEL
from . import count_torch
from .bucketed_torch import (
    BucketedTable,
    auto_buckets,
    bucket_geometry,
    bucketize,
    empty_bucketed,
    flatten_bucketed,
    merge_packed_bucketed,
    route_pack_keys,
)
from .count_hash_torch import count_insert, empty_hash, hash_to_table
from .count_torch import CountTable

# The streaming merge keeps its table in hash buckets (``bucketed="auto"``)
# once one merge passes this many rows: table capacity + the rows of one
# merge. The reference's bound (``models/pipeline.py:57``), measured on its
# TPU's sort cliff, kept unchanged so that both packages pick the same
# layout for the same run and their mid-stream checkpoints cross.
BUCKETED_MIN_MERGE_ROWS = 25 * (1 << 20)
# The bucketed merge's defaults, the reference's: batches routed into the
# staging buffer between two table merges, and the slack of a bucket's
# table rows (cb) and of its rows from one batch (m) over the uniform
# expectation.
BUCKET_ACCUM = 4
BUCKET_CB_SLACK = 1.25
BUCKET_M_SLACK = 1.5

SNAPSHOT_DROPS = (
    "the bucketed checkpoint cannot hold this count: a hash bucket of its "
    "form has more keys than its rows, though the table's unique keys fit "
    "its capacity (the sort merges would flag this table as overflowed); "
    "checkpoint with bucketed='off', or count without stream_checkpoint")


def uses_hash_table(device: torch.device, nl: int) -> bool:
    """Whether a carried table on ``device`` of ``nl``-limb keys is the
    card's hash table: one-limb keys on a CUDA device."""
    return device.type == "cuda" and nl == 1


def use_bucketed(bucketed: str, merge_rows: int) -> bool:
    """Whether a streamed count keeps its table in hash buckets: ``"on"``,
    ``"off"``, or ``"auto"`` (``merge_rows`` = rows of one merge, at least
    BUCKETED_MIN_MERGE_ROWS)."""
    if bucketed not in ("auto", "on", "off"):
        raise ValueError(f"bucketed must be 'auto', 'on' or 'off', got "
                         f"{bucketed!r}")
    if bucketed == "auto":
        return merge_rows >= BUCKETED_MIN_MERGE_ROWS
    return bucketed == "on"


class BucketPlan(NamedTuple):
    """Geometry of a bucketed stream: nb buckets of cb table rows, m rows a
    bucket from one batch, accum batches between two table merges (the
    reference's checkpoint params of the layout, by these names)."""

    nb: int
    cb: int
    m: int
    accum: int


def bucket_plan(capacity: int, merge_windows: int, *, buckets: int | None,
                accum: int | None) -> BucketPlan:
    """The reference's geometry for a table of ``capacity`` rows fed
    ``merge_windows`` rows a batch: ``auto_buckets`` unless ``buckets`` is
    given, BUCKET_ACCUM unless ``accum`` is."""
    accum = BUCKET_ACCUM if accum is None else max(1, accum)
    nb = buckets or auto_buckets(capacity, merge_windows, accum,
                                 BUCKET_CB_SLACK, BUCKET_M_SLACK)
    cb, m = bucket_geometry(capacity, merge_windows, nb=nb,
                            cb_slack=BUCKET_CB_SLACK, m_slack=BUCKET_M_SLACK)
    return BucketPlan(nb, cb, m, accum)


def stride_taken(merge_stride: int | None, n_batches: int) -> int:
    """The stride a stream of ``n_batches`` batches runs at: the
    reference's rule, deferred merges only with ``merge_stride`` > 1 and
    more than one batch (else 1; None or 0 is 1, as there)."""
    stride = merge_stride or 1
    return stride if stride > 1 and n_batches > 1 else 1


def stream_layout(capacity: int, merge_rows: int, stride: int,
                  bucketed: str = "auto", buckets: int | None = None,
                  accum: int | None = None
                  ) -> tuple[BucketPlan | None, dict[str, int]]:
    """The layout of a carried table of ``capacity`` rows fed
    ``merge_rows`` rows a merge (``stride`` batches' rows) -> (its
    ``BucketPlan``, None for the flat layout; the layout's checkpoint
    params, ``bucketed`` and the plan's fields). ``bucketed`` picks it by
    ``use_bucketed`` on capacity + merge_rows; ``buckets`` and ``accum``
    set the bucket count and the cadence (accumulation 1 under a
    stride)."""
    if not use_bucketed(bucketed, capacity + merge_rows):
        return None, {"bucketed": 0}
    plan = bucket_plan(capacity, merge_rows, buckets=buckets,
                       accum=1 if stride > 1 else accum)
    return plan, {"bucketed": 1, **plan._asdict()}


class BucketedStream:
    """The bucketed merge of one running table.

    Each batch is only routed into its slot of a staging buffer of
    [nb, accum * m] rows, and the staged rows merge into the table once
    ``accum`` slots are full (the reference's accumulated staging; with
    ``accum`` 1 every batch merges): merges aggregate associatively and a
    key's bucket never changes, so the table equals per-batch merging.
    Routing overflow waits in ``pending`` and folds into the table's flag
    at the next merge."""

    def __init__(self, table: BucketedTable, plan: BucketPlan):
        self.table, self.plan, self.slot = table, plan, 0
        nb, _, nl = table.limbs.shape
        self.staging = table.limbs.new_full(
            (nb, plan.accum * plan.m, nl), SENTINEL)
        self.pending = torch.zeros((), dtype=torch.bool,
                                   device=table.limbs.device)

    @property
    def at_boundary(self) -> bool:
        """No routed batch waits for its merge (a snapshot may be taken)."""
        return self.slot == 0

    def add(self, keys: torch.Tensor, route_overflow=None) -> None:
        """One batch's raw keys (sentinel rows ignored); ``route_overflow``
        a flag of the step that produced them."""
        p = self.plan
        packed, over_m = route_pack_keys(keys, p.nb, p.m)
        self.staging[:, self.slot * p.m : (self.slot + 1) * p.m] = packed
        self.pending = self.pending | over_m
        if route_overflow is not None:
            self.pending = self.pending | route_overflow
        self.slot += 1
        if self.slot == p.accum:
            self.flush()

    def flush(self) -> None:
        """Merge the filled staging slots into the table."""
        if self.slot:
            self.table = merge_packed_bucketed(
                self.table, self.staging[:, : self.slot * self.plan.m],
                self.pending)
            self.pending = torch.zeros_like(self.pending)
            self.slot = 0


class CarriedTable:
    """One device's or one shard's running table of a streamed count:
    ``capacity`` rows of ``nl``-limb keys on ``device``, in the layout of
    ``plan`` (a ``BucketPlan``, or None for the flat layout), merged at
    ``stride``. ``table`` is a resumed checkpoint's table (a BucketedTable
    in the bucketed layout), or None to start empty.

    Under a stride above 1 (the reference's deferred merges) the raw keys
    of up to ``stride`` batches wait in one device buffer of
    ``pending_rows`` rows and merge at once, so the table's capacity-sized
    sort runs once per ``stride`` batches. Batch after batch lands behind
    the last one (a short batch leaves no gap), and a merge takes only the
    filled rows, so no key of an earlier round is merged twice; the
    routing flags of the waiting batches wait with them. Merges aggregate
    associatively and ignore sentinel rows: the table equals merging every
    batch.

    Where ``uses_hash_table`` (one-limb keys on a card) the table is
    ``hash``, a ``HashCounts``, and every batch is inserted at once;
    ``hash_batches`` counts them. A resumed table's rows go in with their
    counts. Only the checkpoint cadence of the layout and stride is kept:
    ``at_boundary`` holds after every ``stride`` x accumulation batches,
    where the sort merges would have merged. Overflow is then flagged
    only when the unique keys pass ``capacity`` (or routing overflowed),
    never for one full bucket."""

    def __init__(self, capacity: int, nl: int, device: torch.device,
                 plan: BucketPlan | None, stride: int = 1,
                 pending_rows: int = 0,
                 table: CountTable | BucketedTable | None = None):
        self.capacity, self.nl, self.device = capacity, nl, device
        self.plan, self.hash, self.hash_batches = plan, None, 0
        if uses_hash_table(torch.device(device), nl):
            self._init_hash(stride, table)
            return
        self.stream = None
        if plan is not None:
            self.stream = BucketedStream(
                table if table is not None
                else empty_bucketed(plan.nb, plan.cb, nl, device), plan)
            table = None
        self.table = table  # the flat table; None before its first merge
        self.stride, self.waiting, self.fill = stride, 0, 0
        if stride > 1:
            self.buf = torch.empty((pending_rows, nl), dtype=torch.int64,
                                   device=device)
            self.overflow = torch.zeros((), dtype=torch.bool, device=device)

    def _init_hash(self, stride: int, table) -> None:
        self.hash = empty_hash(self.capacity, self.device)
        self.cadence = stride * (1 if self.plan is None else self.plan.accum)
        self.overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        if table is not None:  # a resumed table: its rows with their counts
            count_insert(self.hash, table.limbs.reshape(-1, 1),
                         table.counts.reshape(-1))
            self.overflow = self.overflow | table.overflow

    @property
    def at_boundary(self) -> bool:
        """No added batch waits for its merge: a checkpoint may be taken."""
        if self.hash is not None:
            return self.hash_batches % self.cadence == 0
        return self.waiting == 0 and (self.stream is None
                                      or self.stream.at_boundary)

    def snapshot(self) -> tuple[CountTable | BucketedTable, torch.Tensor]:
        """The table a checkpoint saves, flat or bucketed (at a boundary),
        and a 0-d bool set where that form drops keys the running table
        holds. Only a hash table under a bucketed plan can set it: the
        table is exact while its unique keys fit the capacity, but a bucket
        of the saved form holds ``cb`` rows, and a resume would carry the
        truncated bucket's overflow. The caller refuses such a checkpoint
        (``SNAPSHOT_DROPS``)."""
        none_dropped = torch.zeros((), dtype=torch.bool, device=self.device)
        if self.hash is None:
            return (self.table if self.stream is None
                    else self.stream.table), none_dropped
        flat = self._hash_table()
        if self.plan is None:
            return flat, none_dropped
        bt = bucketize(flat, self.plan.nb, self.plan.cb)
        return bt, bt.overflow & ~flat.overflow

    def _hash_table(self) -> CountTable:
        table = hash_to_table(self.hash)
        return table._replace(overflow=table.overflow | self.overflow)

    def add(self, keys: torch.Tensor, route_overflow=None) -> None:
        """One batch's raw keys (sentinel rows ignored); ``route_overflow``
        a 0-d bool of the routing that delivered them, or None."""
        if self.hash is not None:
            count_insert(self.hash, keys.contiguous())
            self.hash_batches += 1
            if route_overflow is not None:
                self.overflow = self.overflow | route_overflow
            return
        if self.stride == 1:
            self._merge(keys, route_overflow)
            return
        n = keys.shape[0]
        self.buf[self.fill : self.fill + n] = keys
        self.fill += n
        self.waiting += 1
        if route_overflow is not None:
            self.overflow = self.overflow | route_overflow
        if self.waiting == self.stride:
            self._merge_waiting()

    def _merge_waiting(self) -> None:
        keys, over = self.buf[: self.fill], self.overflow
        self.waiting = self.fill = 0
        self.overflow = torch.zeros_like(over)
        self._merge(keys, over)

    def _merge(self, keys: torch.Tensor, over) -> None:
        if self.stream is not None:
            self.stream.add(keys, over)
            return
        if self.table is None:
            table = count_torch.resize_table(count_torch.count_keys(keys),
                                             self.capacity)
        else:
            table = count_torch.merge_raw_keys(self.table, keys)
        self.table = (table if over is None
                      else table._replace(overflow=table.overflow | over))

    def finish(self) -> CountTable:
        """Merge what still waits -> the flat compact-front table of
        ``capacity`` rows."""
        if self.hash is not None:
            return self._hash_table()
        if self.waiting:
            self._merge_waiting()
        if self.stream is not None:
            self.stream.flush()
            return flatten_bucketed(self.stream.table, self.capacity)
        if self.table is None:  # no batch at all
            return count_torch.empty_table(self.capacity, self.nl,
                                           self.device)
        return self.table


def count_hash_use(metrics, carried: list[CarriedTable]) -> None:
    """Where the carried tables are hash tables, count in ``metrics`` (a
    ``Metrics`` or None) ``hash_batches``, the batches inserted (each local
    table sees every batch: the most of any), and ``hash_slots``, the
    slots of the tables, summed."""
    hashed = [c.hash for c in carried if c.hash is not None]
    if metrics is not None and hashed:
        metrics.count("hash_batches", max(c.hash_batches for c in carried))
        metrics.count("hash_slots", sum(h.slots.shape[0] for h in hashed))
