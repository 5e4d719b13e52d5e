"""Single-device assembly pipeline in PyTorch.

Counterpart of ``genome_assembler_tpu/models/pipeline.py::assemble_tpu``:

  2-bit-packed reads -> canonical k-mers   ops.kmer_torch (CUDA kernel)
  count (single shot, flat streaming, or   ops.count_torch,
    hash-bucketed streaming)               ops.bucketed_torch
  compaction + coverage filter             ops.count_torch
  unitig compression (odd k)               ops.unitig_torch
  spelling reduction                       ops.unitig_torch + host.dbg
  simplification + traversal               the port's own NumPy host
                                           modules (host.*)

Reads cross to the device as raw one-byte codes and are packed there (4
bases per byte, ambiguous bases as a separate bit plane) for the kernel,
in one pass that also finds whether the batch holds an ambiguous base:
the host never scans the reads for one. Everything from the pack to the
spelling reduction stays on the device.
The streaming counter uploads through ``utils.upload.UploadRing``: pinned
host slots, a copy stream, two batches queued ahead of the one being
counted, and nothing between two batches that waits for the device.
Even k takes the reference's host-dict graph branch. The streaming
counter can snapshot its table and batch cursor mid-stream and resume
from such a snapshot, in the reference's format. Past
``BUCKETED_MIN_MERGE_ROWS`` rows a merge (the reference's bound) it keeps
its table in hash buckets and merges every ``BUCKET_ACCUM`` batches, as
the reference does, so both packages pick one layout for one run. With a
merge stride s (``merge_stride``) the raw keys of s batches wait on the
device (``PendingKeys``) and merge at once, in either layout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..host.dbg import counts_to_dict
from ..host.simplify import simplify_counts
from ..host.simplify_arrays import simplify_arrays_to_graph
from ..host.traverse import counted_into, emit_contigs, emit_contigs_euler
from ..utils.config import AssemblyConfig
from ..utils.metrics import Metrics

from ..host.dbg import spell_device_arrays
from ..ops import count_torch
from ..ops.bucketed_torch import (
    BucketedTable,
    auto_buckets,
    bucket_geometry,
    bucketed_from_numpy,
    bucketed_to_numpy,
    empty_bucketed,
    flatten_bucketed,
    merge_packed_bucketed,
    route_pack_keys,
)
from ..ops.count_torch import CountTable
from ..ops.kmer_torch import extract_canonical_flat, pack_on_device
from ..ops.unitig_torch import compress_unitigs_device
from ..utils.device import resolve_device
from ..utils.keys import SENTINEL, limbs_to_words, n_limbs
from ..utils.upload import UploadRing

# Above this many windows the counter streams batches into a bounded
# table instead of counting all windows in one shot (the reference's
# default, pipeline.py SINGLE_SHOT_WINDOWS).
SINGLE_SHOT_WINDOWS = 1 << 27
# Batches uploaded ahead of the one being counted (the reference's
# prefetch depth).
UPLOAD_PREFETCH = 2
# The streaming merge keeps its table in hash buckets (``bucketed="auto"``)
# once one merge passes this many rows: table capacity + one batch's
# windows. The reference's bound (``models/pipeline.py:57``), measured on
# its TPU's sort cliff, kept unchanged so that both packages pick the same
# layout for the same run and their mid-stream checkpoints cross.
BUCKETED_MIN_MERGE_ROWS = 25 * (1 << 20)
# The bucketed merge's defaults, the reference's: batches routed into the
# staging buffer between two table merges, and the slack of a bucket's
# table rows (cb) and of its rows from one batch (m) over the uniform
# expectation.
BUCKET_ACCUM = 4
BUCKET_CB_SLACK = 1.25
BUCKET_M_SLACK = 1.5


def timed_stage(m: Metrics, name: str, devices, after=None):
    """``m.stage(name, devices, after)``: the stage's wall time, closed by
    a synchronise of ``devices`` (every stream of each, the copy streams
    too) and then ``after`` (a multi-process mesh's barrier)."""
    return m.stage(name, devices, after)


def _count_batch(
    packed: torch.Tensor,
    read_len: int,
    k: int,
    inv_bits: torch.Tensor | None = None,
    out_cap: int | None = None,
    flag: torch.Tensor | None = None,
    masked: torch.Tensor | None = None,
) -> CountTable:
    """Extract + canonicalize + sort-count one packed read batch; out_cap
    truncates (flagging overflow) or pads the table to that capacity.
    ``flag`` and ``masked`` go to ``extract_canonical_flat``: the pack's
    flag of the batch, and the device counter of masked windows."""
    keys = extract_canonical_flat(packed, read_len, k, inv_bits=inv_bits,
                                  flag=flag, masked=masked)
    table = count_torch.count_keys(keys)
    if out_cap is not None:
        table = count_torch.resize_table(table, out_cap)
    return table


def _stream_step(
    table: CountTable,
    packed: torch.Tensor,
    read_len: int,
    k: int,
    inv_bits: torch.Tensor | None = None,
    flag: torch.Tensor | None = None,
    masked: torch.Tensor | None = None,
) -> CountTable:
    """Count one batch into the running table: the raw canonical key
    stream weighted-merges straight into it (``merge_raw_keys``);
    ``flag`` and ``masked`` as for ``_count_batch``."""
    keys = extract_canonical_flat(packed, read_len, k, inv_bits=inv_bits,
                                  flag=flag, masked=masked)
    return count_torch.merge_raw_keys(table, keys)


def pack_batch(codes: torch.Tensor, counts: torch.Tensor | None = None):
    """A batch's raw [B, L] codes on its device -> (packed codes, the
    keywords of ``extract_canonical_flat`` for them). The pack finds the
    batch's ambiguous bases on the device (its flag), and the kernel reads
    the invalid bits only where the flag is set; nothing waits for the
    device. ``counts`` (int64 [2] on the device, or None) gains the
    windows masked for an ambiguous base and, for a batch that holds one,
    1."""
    masked, batches = (None, None) if counts is None else counts
    packed, inv, flag = pack_on_device(codes, batches)
    return packed, dict(inv_bits=inv, flag=flag, masked=masked)


def count_ambiguous(reads: np.ndarray, k: int, batch: int,
                    device: torch.device, counts: torch.Tensor) -> None:
    """Add to ``counts`` (int64 [2] on ``device``) what a count of
    ``reads`` in batches of ``batch`` reads adds: the masked windows and
    the batches that hold an ambiguous base. Each batch is packed and
    extracted on the device as the count does, its keys dropped; for the
    reads a resumed run does not count (the batches before a stream
    checkpoint's cursor, or all of them after a finished table's)."""
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    for s in range(0, reads.shape[0], batch):
        codes = torch.from_numpy(reads[s : s + batch]).to(device)
        packed, ext = pack_batch(codes, counts)
        extract_canonical_flat(packed, reads.shape[1], k, **ext)


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


class BucketedStream:
    """The bucketed merge of one running table (one device, or one shard).

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

    def finish(self, capacity: int) -> CountTable:
        """Flush the tail, then the flat compact-front table of
        ``capacity`` rows."""
        self.flush()
        return flatten_bucketed(self.table, capacity)


class PendingKeys:
    """Deferred merges (the reference's merge stride): the raw keys of up
    to ``stride`` batches wait in one device buffer of ``rows`` rows, and
    the table merges them all at once, so its capacity-sized sort runs
    once per ``stride`` batches. Batch after batch lands behind the last
    one (a short batch leaves no gap), and a merge takes only the filled
    rows, so no key of an earlier round is merged twice. Merges aggregate
    associatively and ignore sentinel rows: the table equals merging
    every batch. ``overflow`` gathers the routing flags of the waiting
    batches (the sharded stream's) until they merge."""

    def __init__(self, stride: int, rows: int, nl: int,
                 device: torch.device):
        self.stride, self.slot, self.fill = stride, 0, 0
        self.buf = torch.empty((rows, nl), dtype=torch.int64, device=device)
        self.overflow = torch.zeros((), dtype=torch.bool, device=device)

    @property
    def at_boundary(self) -> bool:
        """No batch waits for its merge (a snapshot may be taken)."""
        return self.slot == 0

    def add(self, keys: torch.Tensor, route_overflow=None) -> bool:
        """Append one batch's raw keys; True once ``stride`` batches wait."""
        n = keys.shape[0]
        self.buf[self.fill : self.fill + n] = keys
        self.fill += n
        self.slot += 1
        if route_overflow is not None:
            self.overflow = self.overflow | route_overflow
        return self.slot == self.stride

    def merge(self, table: CountTable | None,
              stream: "BucketedStream | None") -> CountTable | None:
        """Merge the waiting keys, with their routing flag, into
        ``stream`` (in place; its plan merges once an ``add``) or else
        into the flat ``table``; returns the flat table (``table`` as it
        was under a stream). The buffer is empty after it."""
        keys, over = self.buf[: self.fill], self.overflow
        self.slot = self.fill = 0
        self.overflow = torch.zeros_like(over)
        if stream is not None:
            stream.add(keys, over)
            return table
        merged = count_torch.merge_raw_keys(table, keys)
        return merged._replace(overflow=merged.overflow | over)


def stride_taken(merge_stride: int | None, n_batches: int) -> int:
    """The stride a stream of ``n_batches`` batches runs at: the
    reference's rule, deferred merges only with ``merge_stride`` > 1 and
    more than one batch (else 1; None or 0 is 1, as there)."""
    stride = merge_stride or 1
    return stride if stride > 1 and n_batches > 1 else 1


def save_stream_checkpoint(
    table: CountTable | BucketedTable, path: str, k: int, *,
    next_start: int, params: dict[str, int],
) -> None:
    """Mid-stream checkpoint: the carried table and the batch cursor, in
    the reference's format (``models/pipeline.py save_stream_checkpoint``:
    uint32 words, int32 counts, num_unique, overflow, next_start and the
    run's ``params``; a bucketed table as words [nb, cb, W], counts
    [nb, cb] and num_unique [nb]), so either package resumes the other's.
    ``params`` pins everything the resumed table depends on; a resume
    refuses a mismatch."""
    to_numpy = (bucketed_to_numpy if isinstance(table, BucketedTable)
                else count_torch.count_table_to_numpy)
    words, counts, num, over = to_numpy(table, k)
    np.savez_compressed(
        path, words=words, counts=counts, num_unique=num, overflow=over,
        next_start=np.asarray(next_start),
        **{name: np.asarray(v) for name, v in params.items()},
    )


_CHECKPOINT_KINDS = {
    "table": "a finished count; pass it as resume_from to assemble_torch "
             "or assemble_distributed",
    "stream": "a single-device mid-stream checkpoint; resume it with "
              "assemble_torch(resume_from=...) (ga-torch assemble "
              "--backend torch)",
    "sharded_stream": "a sharded mid-stream checkpoint; resume it with "
                      "assemble_distributed(resume_from=...) (ga-torch "
                      "assemble --backend dist)",
    "sharded_table": "a sharded-graph table; resume it with "
                     "assemble_distributed_sharded(resume_from=...) "
                     "(ga-torch assemble --backend dist --sharded-graph) "
                     "on a mesh of its shard count",
}


def checkpoint_kind(path: str) -> str:
    """Which of either package's checkpoint .npz files ``path`` is: a key
    of ``_CHECKPOINT_KINDS``."""
    with np.load(path) as z:
        if "next_start" in z.files:
            return "stream"
        if "layout" not in z.files:
            return "table"
        return "sharded_stream" if "next_batch" in z.files else "sharded_table"


def require_checkpoint_kind(path: str, kind: str) -> None:
    """Refuse, with the way to resume it, a checkpoint of another kind."""
    got = checkpoint_kind(path)
    if got != kind:
        raise ValueError(f"{path} is {_CHECKPOINT_KINDS[got]}")


def is_stream_checkpoint(path: str) -> bool:
    """True if ``path`` is a single-device mid-stream checkpoint."""
    return checkpoint_kind(path) == "stream"


class StreamCursor:
    """The cursor policy of both streaming counters, for a call that runs
    batches ``start..n-1``: once ``every`` batches have passed since the
    call began or since the last snapshot, the first batch after which no
    routed batch waits for its merge (every batch of a flat merge), bar
    the last batch, ``save(i + 1)`` snapshots (``save`` None: no
    snapshots); after ``abort_after_batch`` batches of the call it raises
    (the tests' stand-in for a killed run). The reference's policy, so
    both packages snapshot at the same cursors."""

    def __init__(self, start: int, n: int, *, every: int, save,
                 abort_after_batch: int):
        self.start, self.n, self.every, self.save = start, n, every, save
        self.abort_after_batch, self.since = abort_after_batch, 0

    def after(self, i: int, at_boundary: bool = True) -> None:
        """Run after batch ``i``."""
        self.since += 1
        if (self.save is not None and self.every > 0
                and self.since >= self.every and at_boundary
                and i + 1 < self.n):
            self.save(i + 1)
            self.since = 0
        done = i + 1 - self.start
        if self.abort_after_batch and done >= self.abort_after_batch:
            raise RuntimeError(
                f"fault injection: abort_after_batch={self.abort_after_batch}"
                f" reached at batch {i + 1}/{self.n}"
            )


def load_stream_checkpoint(
    path: str, device: torch.device | str
) -> tuple[CountTable | BucketedTable, int, dict[str, int]]:
    """-> (carried table on ``device``, next_start, params); a table saved
    in the bucketed layout comes back as a BucketedTable."""
    require_checkpoint_kind(path, "stream")
    table_keys = ("words", "counts", "num_unique", "overflow")
    with np.load(path) as z:
        from_numpy = (bucketed_from_numpy if z["words"].ndim == 3
                      else count_torch.count_table_from_numpy)
        table = from_numpy(
            *(z[name] for name in table_keys), device=resolve_device(device)
        )
        params = {
            name: int(z[name])
            for name in z.files
            if name not in table_keys + ("next_start",)
        }
        return table, int(z["next_start"]), params


def count_reads_device(
    reads: np.ndarray,
    cfg: AssemblyConfig,
    *,
    device: torch.device | str,
    table_capacity: int | None = None,
    stream_checkpoint: str | None = None,
    stream_checkpoint_every: int = 0,
    resume_stream_from: str | None = None,
    abort_after_batch: int = 0,
    bucketed: str = "auto",
    merge_stride: int | None = None,
    metrics: Metrics | None = None,
    ambiguous_counts: torch.Tensor | None = None,
    _plain_upload: bool = False,
    _buckets: int | None = None,
    _bucket_accum: int | None = None,
) -> CountTable:
    """Count canonical k-mers of [B, L] reads on ``device``.

    table_capacity: unique-k-mer capacity of the streaming table. Without
    it, read sets up to SINGLE_SHOT_WINDOWS windows count in one shot
    (capacity = window count); larger ones stream with capacity
    SINGLE_SHOT_WINDOWS. Streaming uploads ``cfg.batch_reads`` reads per
    batch; the first batch counts straight into a table padded to the
    capacity, every later one merges its raw keys into it. The kernel
    takes any batch size, so the short last batch is not padded. On a
    card the batches go through an ``UploadRing`` (``UPLOAD_PREFETCH``
    batches ahead); on the CPU, or with ``_plain_upload`` (the on-card
    checks' yardstick), each batch is moved by a plain ``.to(device)``.

    bucketed: the streaming table's layout, ``"auto"`` (hash buckets once
    capacity + one batch's windows reach BUCKETED_MIN_MERGE_ROWS), ``"on"``
    or ``"off"``; the result is the same table either way. In the bucketed
    layout each batch is routed to its buckets and the routed batches
    merge every BUCKET_ACCUM batches (``BucketedStream``); ``_buckets`` and
    ``_bucket_accum`` set the bucket count and that cadence (for tests).

    ambiguous_counts: an int64 [2] tensor on ``device`` that gains, on the
    device, the windows masked for an ambiguous base (N) and the batches
    that held one, over every batch of the reads (on a resumed stream
    the batches before the checkpoint's cursor too, ``count_ambiguous``);
    the pack finds them batch by batch (``pack_batch``), and no host pass
    scans the reads.

    merge_stride: deferred merges. With a stride s > 1 and more than one
    batch, each batch's raw keys only wait in a ``PendingKeys`` buffer,
    and the table merges s batches at once (from an empty table; the
    tail merges what waits). The layout rule then counts s batches'
    windows, and the bucketed layout merges once per s batches
    (accumulation 1). The table is the same at any stride. ``metrics``
    (if given) counts the stride a streamed count took as
    ``merge_stride`` where one was asked for, and adds up the count's
    host spans: ``count.setup`` (entry to the first batch),
    ``count.fill`` and ``count.step`` (each batch's copy into host
    memory, and its pack, extraction and merge as enqueued),
    ``count.wait`` (the ring blocked on a copy) and ``count.finish`` (the
    tail merge).

    stream_checkpoint + stream_checkpoint_every=N: once N streamed batches
    have passed (in the bucketed layout or under a stride: at the next
    merge), snapshot the carried table and the batch cursor to
    ``stream_checkpoint``; resume_stream_from continues from such a
    snapshot (written by either package) to the same table as an
    uninterrupted run. The snapshot's k, batch, capacity, stride, read
    count and layout must match this run's.
    abort_after_batch=n raises after n batches of this call (the tests'
    stand-in for a killed run).
    """
    device = resolve_device(device)
    m = metrics if metrics is not None else Metrics()
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    b, length = reads.shape
    total_windows = b * (length - cfg.k + 1)
    batch = cfg.batch_reads
    starts = range(0, b, batch)
    stride = stride_taken(merge_stride, len(starts))

    if table_capacity is None and total_windows <= SINGLE_SHOT_WINDOWS:
        if resume_stream_from is not None:
            raise ValueError(
                "resume_stream_from requires the streaming path; pass the "
                "table_capacity the checkpointed run used"
            )
        with m.span("count.fill"):
            codes = torch.from_numpy(reads).to(device)
        with m.span("count.step"):
            packed, ext = pack_batch(codes, ambiguous_counts)
            return _count_batch(packed, length, cfg.k, **ext)

    with m.span("count.setup"):
        capacity = table_capacity or min(total_windows, SINGLE_SHOT_WINDOWS)
        bw = batch * (length - cfg.k + 1)
        if merge_stride is not None:
            m.count("merge_stride", stride)
        merge_windows = stride * bw
        # everything the carried table depends on: the reference's keys
        ck_params = {
            "k": cfg.k, "batch": batch, "capacity": capacity,
            "stride": stride, "total_reads": b,
            "bucketed": int(use_bucketed(bucketed, capacity + merge_windows)),
        }
        plan = None
        if ck_params["bucketed"]:
            # under a stride the pending rows merge at once (accumulation 1)
            plan = bucket_plan(capacity, merge_windows, buckets=_buckets,
                               accum=1 if stride > 1 else _bucket_accum)
            ck_params.update(plan._asdict())
        table = None
        start_idx = 0
        if resume_stream_from is not None:
            table, next_start, got = load_stream_checkpoint(
                resume_stream_from, device
            )
            if got != ck_params:
                raise ValueError(
                    f"mid-stream checkpoint mismatch: saved {got}, this run "
                    f"has {ck_params}; resume requires identical k/batch/"
                    "capacity/stride/read set/layout"
                )
            start_idx = next_start // batch
            if ambiguous_counts is not None:
                count_ambiguous(reads[:next_start], cfg.k, batch, device,
                                ambiguous_counts)
        stream = None
        if plan is not None:
            stream = BucketedStream(
                table if table is not None else empty_bucketed(
                    plan.nb, plan.cb, n_limbs(cfg.k), device),
                plan,
            )
        pending = None
        if stride > 1:
            pending = PendingKeys(stride, min(merge_windows, total_windows),
                                  n_limbs(cfg.k), device)
            if table is None and stream is None:
                table = count_torch.empty_table(capacity, n_limbs(cfg.k),
                                                device)
        ring = UploadRing(
            [(device, min(batch, b))], [length], depth=UPLOAD_PREFETCH,
            pipelined=False if _plain_upload else None, metrics=m,
        )

    def save(next_batch):
        save_stream_checkpoint(
            table if stream is None else stream.table, stream_checkpoint,
            cfg.k, next_start=starts[next_batch], params=ck_params,
        )

    def fill(i, planes):
        rows = reads[starts[i] : starts[i] + batch]
        planes[0][: rows.shape[0]] = rows
        return rows.shape[0]

    cursor = StreamCursor(
        start_idx, len(starts), every=stream_checkpoint_every,
        save=None if stream_checkpoint is None else save,
        abort_after_batch=abort_after_batch,
    )
    # the ring's own spans: count.fill (each fill) and count.wait
    with ring:
        for i, [[codes]] in ring.stream(start_idx, len(starts), fill):
            with m.span("count.step"):
                packed, ext = pack_batch(codes, ambiguous_counts)
                if pending is not None:
                    if pending.add(extract_canonical_flat(
                            packed, length, cfg.k, **ext)):
                        table = pending.merge(table, stream)
                elif stream is not None:
                    stream.add(extract_canonical_flat(packed, length, cfg.k,
                                                      **ext))
                elif table is None:
                    table = _count_batch(packed, length, cfg.k,
                                         out_cap=capacity, **ext)
                else:
                    table = _stream_step(table, packed, length, cfg.k, **ext)
            # the table after batch i, whatever is already uploaded
            cursor.after(i, (pending is None or pending.at_boundary)
                         and (stream is None or stream.at_boundary))
    with m.span("count.finish"):
        if pending is not None and not pending.at_boundary:
            table = pending.merge(table, stream)
        if stream is not None:
            return stream.finish(capacity)
        if table is None:  # no reads at all
            table = count_torch.empty_table(capacity, n_limbs(cfg.k), device)
        return table


def table_to_host_counts(table: CountTable, k: int) -> dict[str, int]:
    """Pull the table to the host as {canonical k-mer: count}."""
    if bool(table.overflow):
        raise RuntimeError(
            "k-mer table overflow: unique k-mers exceeded table capacity; "
            "rerun with a larger table_capacity"
        )
    num = int(table.num_unique)
    words = limbs_to_words(table.limbs[:num].cpu().numpy(), k)
    counts = table.counts[:num].cpu().numpy()
    return counts_to_dict(words, counts, k)


def auto_min_count(table_or_counts) -> int:
    """Coverage-filter threshold of a table (the reference heuristic,
    ``models/pipeline.py auto_min_count``; tests hold the two equal). The
    histogram is computed on the table's device; only its 1001 bins
    cross to the host. A plain array of multiplicities is accepted too
    (the oracle passes its dict values, so both paths pick the same
    threshold)."""
    if isinstance(table_or_counts, CountTable):
        table = table_or_counts
        if int(table.num_unique) == 0:
            return 1
        return auto_min_count_hist(
            count_torch.multiplicity_histogram(table).cpu().numpy()
        )
    counts = np.asarray(table_or_counts)
    if counts.size == 0:
        return 1
    return auto_min_count_hist(np.bincount(np.minimum(counts, 1000)))


def auto_min_count_hist(full: np.ndarray) -> int:
    """Coverage-filter threshold at the valley of a multiplicity
    histogram (bin i counts the k-mers seen min(i, 1000) times; bin 0 is
    ignored). Returns 1 when there is no valley."""
    nz = np.nonzero(full)[0]
    if nz.size == 0:
        return 1
    # trailing zero bins trimmed: the heuristic below is length-sensitive
    hist = full[: int(nz[-1]) + 1]
    if len(hist) < 4:
        return 1
    peak = int(np.argmax(hist[3:])) + 3
    if hist[peak] < 4:
        return 1
    valley = int(np.argmin(hist[1:peak])) + 1
    if hist[valley] >= hist[peak]:
        return 1
    return valley + 1  # drop everything at or below the valley bin


def save_table(table: CountTable, path: str, k: int) -> None:
    """Stage-boundary checkpoint of the counted table, in the reference's
    .npz format (``models/pipeline.py save_table``): uint32 words, int32
    counts, num_unique, overflow. Either package resumes from it."""
    words, counts, num, over = count_torch.count_table_to_numpy(table, k)
    np.savez_compressed(
        path, words=words, counts=counts, num_unique=num, overflow=over
    )


def load_table(path: str, device: torch.device | str) -> CountTable:
    """Load a stage-boundary checkpoint written by either package; a
    mid-stream or sharded one is refused with the way to resume it."""
    require_checkpoint_kind(path, "table")
    with np.load(path) as z:
        return count_torch.count_table_from_numpy(
            z["words"], z["counts"], z["num_unique"], z["overflow"],
            device=resolve_device(device),
        )


def assemble_from_table(
    table: CountTable,
    cfg: AssemblyConfig,
    m: Metrics,
    dev: torch.device,
    *,
    emit: str = "unitigs",
    checkpoint: str | None = None,
    return_graph: bool = False,
    after_stage=None,
):
    """The back half shared by ``assemble_torch`` and the sharded
    ``assemble_distributed``: counted table on ``dev`` -> (stage-boundary
    checkpoint) -> coverage filter -> unitigs -> simplified graph ->
    contigs. ``after_stage`` closes every stage (``timed_stage``'s
    ``after``)."""
    if table.limbs.shape[1] != n_limbs(cfg.k):
        raise ValueError(
            f"the table holds keys of another k ({table.limbs.shape[1]} "
            f"limb(s), k={cfg.k} needs {n_limbs(cfg.k)})"
        )
    if checkpoint is not None:
        save_table(table, checkpoint, cfg.k)
    min_count = cfg.min_count or auto_min_count(table)
    with timed_stage(m, "filter", dev, after_stage):
        # compact first: unique k-mers are genome-sized, the counting
        # capacity is read-stream-sized; every pass below scales with it
        if not bool(table.overflow):
            table = count_torch.compact_table(table)
        table = count_torch.filter_table(table, min_count)
        table = count_torch.compact_table(table)
    if cfg.k % 2 == 1:
        if bool(table.overflow):
            raise RuntimeError(
                "k-mer table overflow: rerun with a larger table_capacity"
            )
        with timed_stage(m, "compress", dev, after_stage):
            dev_unitigs = compress_unitigs_device(table, cfg.k)
        with timed_stage(m, "spell", dev, after_stage):
            ua = spell_device_arrays(dev_unitigs, cfg.k)
        with timed_stage(m, "simplify", dev, after_stage):
            graph = simplify_arrays_to_graph(
                ua, cfg.resolved_tip_len, cfg.resolved_bubble_len, min_count
            )
    else:
        # even k: palindromic k-mers rule out device compression; the
        # reference's host-dict graph branch
        with timed_stage(m, "host_graph", dev, after_stage):
            counts = table_to_host_counts(table, cfg.k)
            graph = simplify_counts(
                counts, cfg.k, cfg.resolved_tip_len,
                cfg.resolved_bubble_len, min_count,
            )
    with timed_stage(m, "traverse", dev, after_stage), counted_into(m):
        contigs = (
            emit_contigs_euler(graph) if emit == "euler" else emit_contigs(graph)
        )
    if return_graph:
        return contigs, graph
    return contigs


def assemble_torch(
    reads: np.ndarray,
    cfg: AssemblyConfig,
    *,
    device: torch.device | str = "cuda",
    table_capacity: int | None = None,
    metrics: Metrics | None = None,
    checkpoint: str | None = None,
    resume_from: str | None = None,
    return_graph: bool = False,
    emit: str = "unitigs",
    stream_checkpoint_every: int = 0,
    bucketed: str = "auto",
    merge_stride: int | None = None,
):
    """End-to-end single-device assembly: reads -> canonical contigs.

    device: ``"cuda"`` (default) or ``"cpu"``; CUDA that is not there is
    an error, never a silent CPU run. checkpoint/resume_from: the counted
    table as a stage-boundary .npz (either package's format). With
    stream_checkpoint_every=N > 0 the streaming counter also snapshots
    its table and batch cursor to ``checkpoint`` every N batches;
    resume_from detects such a snapshot and continues counting from it.
    bucketed, merge_stride: the streaming table's layout and merge
    cadence (``count_reads_device``; a stride asked for leaves the stride
    taken in the metrics' ``merge_stride`` counter).
    emit: ``"unitigs"`` stops contigs at junctions, ``"euler"`` spells
    Eulerian walks. Contigs equal ``assemble_tpu``'s and
    ``assemble_oracle``'s. A run leaves the counters
    ``ambiguous_batches`` (batches in which the card found an ambiguous
    base) and, where any window was masked for one, ``masked_windows``,
    read once after the count's closing synchronise; both cover every
    read, on a resumed run too.
    """
    dev = resolve_device(device)
    if emit not in ("unitigs", "euler"):
        raise ValueError(f"emit must be 'unitigs' or 'euler', got {emit!r}")
    m = metrics if metrics is not None else Metrics()
    wc = reads.shape[1] - cfg.k + 1
    m.count("reads", reads.shape[0])
    m.count("kmers", reads.shape[0] * wc)
    resume_stream = (
        resume_from is not None and is_stream_checkpoint(resume_from)
    )
    ambiguous = torch.zeros(2, dtype=torch.int64, device=dev)
    if resume_from is not None and not resume_stream:
        table = load_table(resume_from, dev)
        # the reference counts the masked windows of every read, whatever
        # it resumes: the reads that made the table
        count_ambiguous(reads, cfg.k, cfg.batch_reads, dev, ambiguous)
    else:
        with timed_stage(m, "count", dev):
            table = count_reads_device(
                reads, cfg, device=dev, table_capacity=table_capacity,
                stream_checkpoint=(
                    checkpoint if stream_checkpoint_every > 0 else None
                ),
                stream_checkpoint_every=stream_checkpoint_every,
                resume_stream_from=resume_from if resume_stream else None,
                bucketed=bucketed, merge_stride=merge_stride, metrics=m,
                ambiguous_counts=ambiguous,
            )
    # after the count stage's synchronise: 16 bytes, no wait
    masked, batches = ambiguous.tolist()
    if masked:
        m.count("masked_windows", masked)
    m.count("ambiguous_batches", batches)
    if resume_from is None or resume_stream:
        # the reads in, the keys out and in again to the sort; the
        # reference's figure has 4-byte words, the port's keys are
        # n_limbs(k) 8-byte limbs
        m.count(
            "count_bytes",
            reads.size + 2 * reads.shape[0] * wc * n_limbs(cfg.k) * 8,
        )
    return assemble_from_table(
        table, cfg, m, dev, emit=emit, checkpoint=checkpoint,
        return_graph=return_graph,
    )
