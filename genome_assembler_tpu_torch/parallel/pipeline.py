"""Hash-sharded counting over a mesh of D shards, and the assembly on top.

Counterpart of ``genome_assembler_tpu/parallel/pipeline.py``. Per shard
and read batch:

  1. pack the shard's reads on its device and extract + canonicalize
     them (the CUDA kernels on the card, ``ops.kmer_torch``); the pack's
     flag tells the extraction whether the batch holds an ambiguous base,
     so the host never scans the reads for one;
  2. route each key to its owner ``mix_words(key) % D``
     (``ops.hash_torch``), or each minimizer super-k-mer record to its
     minimizer's owner (``ops.superkmer_torch``);
  3. pack the rows into a fixed [D, bucket_cap, ...] send buffer
     (``bucket_pack``; overflow is flagged, never silent) and exchange the
     buffers (``mesh.all_to_all``);
  4. sort/segment-reduce the received keys into the shard's table: in
     one step, or, streamed, added to the shard's
     ``ops.stream_table.CarriedTable``, the one module that holds the
     merge policy (flat, hash-bucketed past the reference's bound, or
     deferred under a merge stride), the single device's too.

Every per-shard list holds the LOCAL shards of the mesh (all D in one
process; a rank's own under a process group, global shard
``mesh.first_shard + i`` at list position i), and every value that steers
the host's control flow is reduced over all D shards first, so the ranks
of a multi-process run take the same branches in the same rounds.

All occurrences of a canonical k-mer land on one owner, so each shard's
counts are global counts, and the per-shard tables equal the reference's
bit for bit. ``distributed_count_table`` gathers the shard tables onto
shard 0's device and re-counts them with their counts as weights, which
gives the single-device table; the graph stages of ``assemble_distributed``
then run there. ``assemble_distributed_sharded`` instead filters every
shard in place and keeps the graph sharded (``parallel/compress.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..host.simplify_arrays import simplify_arrays_to_graph
from ..host.traverse import counted_into, emit_contigs, emit_contigs_euler
from ..utils.config import AssemblyConfig
from ..utils.dna import key_words
from ..utils.metrics import Metrics

from ..models.pipeline import (
    StreamCursor,
    assemble_from_table,
    auto_min_count_hist,
    checkpoint_kind,
    load_table,
    pack_batch,
    require_checkpoint_kind,
    timed_stage,
)
from ..ops import count_torch
from ..ops.bucketed_torch import (
    BucketedTable,
    bucketed_from_numpy,
    bucketed_to_numpy,
    bucketize,
)
from ..ops.count_torch import CountTable, compact_front_sorted
from ..ops.hash_torch import mix_words, owner_of
from ..ops.kmer_torch import (
    extract_canonical_flat,
    unpack_codes,
    unpack_invalid_mask,
)
from ..ops.stream_table import (
    SNAPSHOT_DROPS,
    CarriedTable,
    count_hash_use,
    stream_layout,
    stride_taken,
)
from ..ops.superkmer_torch import (
    RUN_CAP,
    extract_from_records,
    from_int32_bits,
    mean_run,
    span_words,
    superkmer_records,
    to_int32_bits,
    window_minimizers,
)
from ..utils.keys import SENTINEL, is_sentinel, n_limbs
from ..utils.keys import snug_capacity
from ..utils.upload import UploadRing
from .compress import (
    OVERFLOW_CAPS,
    bucket_pack,
    comm_bytes_estimate,
    make_sharded_compress,
    spell_sharded_arrays,
    wire_bytes,
)
from .mesh import Mesh, all_gather, all_to_all, any_reduce, axis_size
from .mesh import barrier, build_mesh, gather_to_host, is_writer
from .mesh import max_reduce, num_hosts

# Above this many windows per shard, the counter streams read batches into
# carried per-shard tables instead of counting the whole read set at once
# (the reference's default; tests lower it to force the streamed path).
DIST_STREAM_WINDOWS = 1 << 24
# Batches uploaded ahead of the one being routed and merged (the
# reference's depth for the sharded stream).
DIST_UPLOAD_PREFETCH = 1


def _window_bad(bad: torch.Tensor, k: int) -> torch.Tensor:
    """[B, L] bad bases -> [B, L-k+1] windows touching one."""
    wc = bad.shape[1] - k + 1
    out = bad[:, :wc]
    for j in range(1, k):
        out = out | bad[:, j : j + wc]
    return out


def _make_owned_keys(
    mesh: Mesh, k: int, read_len: int, bucket_cap: int,
    minimizer_len: int | None,
):
    """The shared front half of the one-shot and streamed counters:
    fn(packed, n_valid, ext), per-shard packed reads, valid rows and
    ``pack_batch``'s keywords of ``extract_canonical_flat`` (the invalid
    bits and the pack's flag) -> (per-shard received raw keys, sentinel =
    empty lane; per-shard routing-overflow flags)."""
    d = axis_size(mesh)
    wc = read_len - k + 1

    def owned_keys_minimizer(packed, n_valid, ext):
        sw = span_words(k)
        sends, ovfs = [], []
        for i in range(mesh.local_size):
            codes = unpack_codes(packed[i], read_len)
            b = codes.shape[0]
            row_ok = torch.arange(b, device=codes.device) < n_valid[i]
            # the pack's bits: zeros where the batch holds no N
            bad = unpack_invalid_mask(ext[i]["inv_bits"], read_len)
            wv = row_ok[:, None] & ~_window_bad(bad, k)
            hmin, mpos = window_minimizers(codes, k, minimizer_len)
            brk, run, sub, _ = superkmer_records(codes, k, hmin, mpos, wv)
            n = b * wc
            rec = torch.cat(
                [to_int32_bits(sub.reshape(n, sw)),
                 run.reshape(n, 1).to(torch.int32)],
                dim=1,
            )
            send, ovf = bucket_pack(
                rec, hmin.reshape(n) % d, brk.reshape(n), d, bucket_cap, -1
            )
            sends.append(send)
            ovfs.append(ovf)
        keys = []
        for recv in all_to_all(mesh, sends):
            kk, _ = extract_from_records(
                from_int32_bits(recv[:, :sw]), recv[:, sw].to(torch.int64), k
            )
            keys.append(kk)
        return keys, ovfs

    def owned_keys(packed, n_valid, ext):
        if minimizer_len is not None:
            return owned_keys_minimizer(packed, n_valid, ext)
        sends, ovfs = [], []
        for i in range(mesh.local_size):
            kk = extract_canonical_flat(packed[i], read_len, k, n_valid[i],
                                        **ext[i])
            if d == 1:
                # single-owner mesh: every key is already home, no routing
                return [kk], [torch.zeros((), dtype=torch.bool,
                                          device=kk.device)]
            send, ovf = bucket_pack(
                kk, owner_of(kk, k, d), ~is_sentinel(kk), d, bucket_cap,
                SENTINEL,
            )
            sends.append(send)
            ovfs.append(ovf)
        return all_to_all(mesh, sends), ovfs

    return owned_keys


def make_distributed_count(
    mesh: Mesh, k: int, batch_per_device: int, read_len: int,
    bucket_cap: int, minimizer_len: int | None = None,
):
    """The one-shot counting step.

    Returns fn(packed [per-shard [B, ceil(L/4)] uint8], n_valid [per-shard
    int], ext [per-shard ``pack_batch`` keywords]) -> (per-shard
    CountTable, 0-d bool overflow on shard 0's device). Under minimizer
    routing each shard's table is truncated to a window-scale capacity
    (overflow flagged), as in the reference.
    """
    owned = _make_owned_keys(mesh, k, read_len, bucket_cap, minimizer_len)

    def step(packed, n_valid, ext):
        keys, route_ovf = owned(packed, n_valid, ext)
        tables = []
        for kk in keys:
            table = count_torch.count_keys(kk)
            if minimizer_len is not None:
                out_cap = min(
                    kk.shape[0],
                    int(batch_per_device * (read_len - k + 1) * 1.5) + 256,
                )
                if out_cap < table.limbs.shape[0]:
                    table = count_torch.resize_table(table, out_cap)
            tables.append(table)
        overflow = any_reduce(
            mesh, [ro | t.overflow for ro, t in zip(route_ovf, tables)]
        )
        return tables, overflow

    return step


def make_distributed_stream_step(
    mesh: Mesh, k: int, read_len: int, bucket_cap: int,
    minimizer_len: int | None = None,
):
    """The streamed counting step: fn(carried, packed, n_valid, ext)
    routes one batch's keys to their owners, and each shard adds the keys
    it received, with its routing-overflow flag, to its ``CarriedTable``
    (one a local shard), which merges them at its layout's cadence. A
    table's overflow flag also gathers routing overflow; check it after
    the last batch."""
    owned = _make_owned_keys(mesh, k, read_len, bucket_cap, minimizer_len)

    def step(carried, packed, n_valid, ext):
        keys, route_ovf = owned(packed, n_valid, ext)
        for table, kk, ro in zip(carried, keys, route_ovf):
            table.add(kk, ro)

    return step


def _a2a_count_bytes_per_step(
    d: int, k: int, bucket_cap: int, minimizer_len: int | None
) -> int:
    """Bytes one routing step sends, summed over shards: every shard
    sends a [D, bucket_cap, row] buffer, so D x D x bucket_cap rows. A
    row is the port's real send-buffer row: the key's int64 limbs, or a
    record's span_words(k) + 1 int32 columns. Zero when d == 1 (no
    routing)."""
    if d == 1:
        return 0
    if minimizer_len is not None:
        row = 4 * (span_words(k) + 1)
    else:
        row = 8 * n_limbs(k)
    return d * d * bucket_cap * row


def _bucket_cap_for(windows: int, d: int, k: int,
                    minimizer_len: int | None) -> int:
    """Routing-bucket capacity for one shard's window count + skew slack
    (the reference's sizing, so both packages pick the same caps)."""
    if minimizer_len is not None:
        return int(windows / mean_run(k, minimizer_len) / d * 1.6) + 128
    return int(windows / d * 1.5) + 64


def _recv_rows(d: int, k: int, read_len: int, batch_per_device: int,
               bucket_cap: int, minimizer_len: int | None) -> int:
    """Rows of one shard's received key stream a batch (the reference's
    count, which sizes the bucketed geometry)."""
    if minimizer_len is not None:
        return d * bucket_cap * RUN_CAP
    if d == 1:
        return batch_per_device * (read_len - k + 1)
    return d * bucket_cap


class _StreamPlan:
    """Every shape decision of one streamed run, from (read-set shape, cfg,
    mesh size, knobs): the reference's plan. ``stride`` is the merge
    stride taken (``stride_taken``: 1 unless ``merge_stride`` > 1 and
    there is more than one batch). A shard's table takes its layout by
    the single device's rule (``stream_layout``) on c_shard rows fed
    stride x the received rows of a batch a merge (``buckets``: a
    ``BucketPlan``, or None for the flat layout). The resharder rebuilds
    the plan a resumed run will compute, and ``ck_params`` (equal to the
    reference's for the same run) pins it into every mid-stream
    checkpoint."""

    def __init__(self, b, length, cfg, d, bucket_cap, minimizer_len,
                 table_capacity, bucketed: str = "auto",
                 buckets: int | None = None, accum: int | None = None,
                 merge_stride: int | None = None):
        wc = length - cfg.k + 1
        self.per_dev = max(1, cfg.batch_reads // d)
        self.batch_total = self.per_dev * d
        self.num_batches = -(-b // self.batch_total)
        cap_global = table_capacity or min(b * wc, 1 << 26)
        self.c_shard = snug_capacity(int(cap_global / d * 1.3) + 64)
        self.bucket_cap = (
            bucket_cap
            if bucket_cap is not None
            else _bucket_cap_for(self.per_dev * wc, d, cfg.k, minimizer_len)
        )
        self.recv = _recv_rows(d, cfg.k, length, self.per_dev,
                               self.bucket_cap, minimizer_len)
        self.stride = stride_taken(merge_stride, self.num_batches)
        self.buckets, layout = stream_layout(
            self.c_shard, self.stride * self.recv, self.stride, bucketed,
            buckets, accum)
        self.ck_params = {
            "d": d,
            "k": cfg.k,
            "batch_total": self.batch_total,
            "c_shard": self.c_shard,
            "stride": self.stride,
            "total_reads": b,
            "bucket_cap": self.bucket_cap,
            **layout,
            # a key's owner depends on the routing (its hash, or its
            # minimizer's): resuming under another would split keys
            "minimizer": 0 if minimizer_len is None else minimizer_len,
        }


def _tables_to_host(mesh: Mesh | None, tables, k: int):
    """All D shards' tables (CountTables, or BucketedTables) in the
    reference layout (``count_table_to_numpy``'s or ``bucketed_to_numpy``'s
    tuples), on every process. mesh None: the list already holds every
    shard."""
    bucketed = isinstance(tables[0], BucketedTable)
    to_numpy = bucketed_to_numpy if bucketed else count_torch.count_table_to_numpy
    if mesh is None or not mesh.distributed:
        return [to_numpy(t, k) for t in tables]
    cols = (
        gather_to_host(mesh, xs) for xs in (
            [t.limbs for t in tables],
            [t.counts for t in tables],
            [t.num_unique.reshape(-1) for t in tables],
            [t.overflow.reshape(1).to(torch.uint8) for t in tables],
        )
    )
    table = BucketedTable if bucketed else CountTable
    return [
        to_numpy(table(
            torch.from_numpy(limbs), torch.from_numpy(counts),
            torch.from_numpy(num) if bucketed else torch.from_numpy(num)[0],
            torch.from_numpy(ovf)[0] != 0), k)
        for limbs, counts, num, ovf in zip(*cols)
    ]


def _write_shared(mesh: Mesh | None, path: str, **arrays) -> None:
    """One .npz for the whole mesh: the writer process writes it, and no
    process goes on before it is there."""
    if mesh is None or is_writer(mesh):
        np.savez_compressed(path, **arrays)
    if mesh is not None:
        barrier(mesh)


def save_sharded_stream_checkpoint(
    tables: list[CountTable] | list[BucketedTable], path: str, k: int, *,
    next_batch: int, params: dict[str, int], mesh: Mesh | None = None,
) -> None:
    """Mid-stream checkpoint of the sharded streaming counter in the
    reference's format: per-shard tables concatenated (uint32 words
    [D*C, W], int32 counts [D*C], int32 num [D], bool ovf [D]; bucketed
    tables as words [D*nb, cb, W], counts [D*nb, cb], num [D*nb]), the
    batch cursor, the layout tag and ``params``. Either package resumes
    it. ``tables`` are the local shards of ``mesh`` (None: all of them);
    across processes the shards are gathered to the host and rank 0
    writes the one file, byte for byte what a single process writes."""
    parts = _tables_to_host(mesh, tables, k)
    _write_shared(
        mesh, path,
        words=np.concatenate([p[0] for p in parts]),
        counts=np.concatenate([p[1] for p in parts]),
        num=np.concatenate([np.atleast_1d(p[2]) for p in parts]
                           ).astype(np.int32),
        ovf=np.asarray([p[3] for p in parts], dtype=bool),
        next_batch=np.asarray(next_batch),
        layout=np.asarray("hash_shards_stream"),
        **{name: np.asarray(v) for name, v in params.items()},
    )


def is_sharded_stream_checkpoint(path: str) -> bool:
    return checkpoint_kind(path) == "sharded_stream"


def load_sharded_stream_checkpoint(path: str):
    """-> (arrays {words, counts, num, ovf}, next_batch, params)."""
    require_checkpoint_kind(path, "sharded_stream")
    with np.load(path) as z:
        arrays = {name: z[name] for name in ("words", "counts", "num", "ovf")}
        params = {
            name: int(z[name])
            for name in z.files
            if name not in ("words", "counts", "num", "ovf", "next_batch",
                            "layout")
        }
        return arrays, int(z["next_batch"]), params


def _tables_from_arrays(arrays, mesh: Mesh, c_shard: int):
    """The local shards' tables out of a checkpoint's all-D arrays
    (BucketedTables where the words are [D*nb, cb, W])."""
    d = axis_size(mesh)
    if arrays["words"].ndim == 3:
        _, cb, w = arrays["words"].shape
        words = arrays["words"].reshape(d, -1, cb, w)
        counts = arrays["counts"].reshape(d, -1, cb)
        num = arrays["num"].reshape(d, -1)
        return [
            bucketed_from_numpy(words[s], counts[s], num[s],
                                arrays["ovf"][s], device=dev)
            for s, dev in zip(mesh.local_shards, mesh.devices)
        ]
    words = arrays["words"].reshape(d, c_shard, -1)
    counts = arrays["counts"].reshape(d, c_shard)
    return [
        count_torch.count_table_from_numpy(
            words[s], counts[s], arrays["num"][s], arrays["ovf"][s],
            device=dev,
        )
        for s, dev in zip(mesh.local_shards, mesh.devices)
    ]


def reshard_sharded_stream_checkpoint(
    path_in: str, path_out: str, reads_shape: tuple[int, int],
    cfg: AssemblyConfig, new_d: int, *, table_capacity: int | None = None,
    bucketed: str = "auto", merge_stride: int | None = None,
    _buckets: int | None = None, _bucket_accum: int | None = None,
) -> None:
    """Rewrite a mid-stream sharded checkpoint (flat or bucketed layout)
    for a mesh of ``new_d`` shards, so a stopped count resumes on the
    shards that are left. A key's owner is ``mix_words(key) % D``, so this
    repartitions the counted (key, count) rows on the host, re-sorts each
    new shard (keys are unique, so the sort is the merge), puts each into
    hash buckets where the new plan is bucketed (``bucketize``), and writes
    the snapshot that a ``new_d`` resume of the same read set with the same
    capacity, layout and stride arguments (``bucketed``, ``merge_stride``
    and the private knobs, as in ``distributed_count_table``) expects. The
    batch cursor carries over as consumed reads, so ``cfg.batch_reads``
    must give a global batch that divides them. reads_shape: (num_reads,
    read_len) of the original read set.
    """
    b, length = reads_shape
    arrays, next_batch, got = load_sharded_stream_checkpoint(path_in)
    if got.get("minimizer", 0):
        raise ValueError(
            "checkpoint was written by a minimizer-routed stream; a key's "
            "owner there is its minimizer's hash, not its own, so it "
            "cannot be repartitioned by key: resume on the original mesh"
        )
    if got.get("k") != cfg.k or got.get("total_reads") != b:
        raise ValueError(
            f"checkpoint {path_in} is for k={got.get('k')}, "
            f"total_reads={got.get('total_reads')}; this read set has "
            f"k={cfg.k}, total_reads={b}"
        )
    if bool(np.any(arrays["ovf"])):
        raise ValueError(
            f"checkpoint {path_in} carries an overflow flag; it cannot be "
            "resharded (the counts are already unreliable)"
        )
    plan = _StreamPlan(b, length, cfg, new_d, None, None, table_capacity,
                       bucketed, _buckets, _bucket_accum, merge_stride)
    consumed = next_batch * got["batch_total"]
    if consumed % plan.batch_total:
        raise ValueError(
            f"cursor at {consumed} consumed reads does not align with the "
            f"new global batch of {plan.batch_total} (old batch "
            f"{got['batch_total']}); pick batch_reads divisible by both "
            "mesh sizes"
        )
    w = key_words(cfg.k)
    # every old shard's (or bucket's) rows: [tables, rows, W]
    rows = arrays["words"].shape[-2] if got.get("bucketed") else got["c_shard"]
    words3 = arrays["words"].reshape(-1, rows, w)
    valid = np.arange(rows)[None, :] < arrays["num"].reshape(-1)[:, None]
    keys_all = words3[valid]
    counts_all = arrays["counts"].reshape(-1, rows)[valid]
    owner = (
        mix_words(torch.from_numpy(keys_all.astype(np.int64))) % new_d
    ).numpy()

    new_words = np.full((new_d, plan.c_shard, w), 0xFFFFFFFF, dtype=np.uint32)
    new_counts = np.zeros((new_d, plan.c_shard), dtype=np.int32)
    new_num = np.zeros(new_d, dtype=np.int32)
    for s in range(new_d):
        sel = owner == s
        ks, cs = keys_all[sel], counts_all[sel]
        if ks.shape[0] > plan.c_shard:
            raise ValueError(
                f"resharding to d={new_d} overflows shard {s} "
                f"(c_shard={plan.c_shard}); pass a larger table_capacity"
            )
        # big-endian words: column 0 is the primary sort key
        order = np.lexsort(tuple(ks[:, i] for i in range(w - 1, -1, -1)))
        n = ks.shape[0]
        new_words[s, :n] = ks[order]
        new_counts[s, :n] = cs[order]
        new_num[s] = n
    tables = {
        "words": new_words.reshape(new_d * plan.c_shard, w),
        "counts": new_counts.reshape(-1),
        "num": new_num,
    }
    if plan.buckets is not None:
        # the resumed run expects each shard in hash buckets
        parts = [
            bucketed_to_numpy(bucketize(count_torch.count_table_from_numpy(
                new_words[s], new_counts[s], new_num[s], False),
                plan.buckets.nb, plan.buckets.cb), cfg.k)
            for s in range(new_d)
        ]
        if any(p[3] for p in parts):
            raise ValueError(
                f"resharding to d={new_d} overflows a hash bucket of a shard "
                f"(cb={plan.buckets.cb}); pass a larger table_capacity"
            )
        tables = {
            "words": np.concatenate([p[0] for p in parts]),
            "counts": np.concatenate([p[1] for p in parts]),
            "num": np.concatenate([p[2] for p in parts]),
        }
    np.savez_compressed(
        path_out,
        **tables,
        ovf=np.zeros(new_d, dtype=bool),
        next_batch=np.asarray(consumed // plan.batch_total),
        layout=np.asarray("hash_shards_stream"),
        **{name: np.asarray(v) for name, v in plan.ck_params.items()},
    )


def _pack_shards(mesh: Mesh, blocks: list[torch.Tensor], per_dev: int):
    """Raw code rows on the local shards' devices (one [local*per_dev, L]
    block on a single-device mesh, else one [per_dev, L] block a shard) ->
    (packed per shard, ``pack_batch``'s extraction keywords per shard: the
    invalid bits and the pack's flag). A single-device mesh packs once and
    hands out contiguous row views, each with its block's flag."""
    packs = [pack_batch(codes) for codes in blocks]
    if mesh.single_device:
        packed, ext = packs[0]
        packs = [(packed[r : r + per_dev],
                  dict(ext, inv_bits=ext["inv_bits"][r : r + per_dev]))
                 for r in range(0, mesh.local_size * per_dev, per_dev)]
    return [p for p, _ in packs], [e for _, e in packs]


def _upload_shards(mesh: Mesh, rows: np.ndarray, per_dev: int,
                   metrics: Metrics | None):
    """One plain upload of this process's rows of [D*per_dev, L] host
    reads, packed on the local shards' devices: ``_pack_shards``'s
    (packed, ext)."""
    rows = rows[mesh.first_shard * per_dev :
                (mesh.first_shard + mesh.local_size) * per_dev]
    if metrics is not None:
        metrics.count("h2d_bytes_reads", rows.nbytes)
    host = torch.from_numpy(rows)
    if mesh.single_device:
        blocks = [host.to(mesh.devices[0])]
    else:
        blocks = [host[i * per_dev : (i + 1) * per_dev].to(dev)
                  for i, dev in enumerate(mesh.devices)]
    return _pack_shards(mesh, blocks, per_dev)


def _stream_batches(mesh: Mesh, reads: np.ndarray, plan: _StreamPlan,
                    first: int, metrics: Metrics | None = None,
                    *, pipelined: bool | None = None):
    """Batches ``first..`` of a streamed run on the local shards, uploaded
    ``DIST_UPLOAD_PREFETCH`` ahead through an ``UploadRing`` with one copy
    stream a distinct device (a single-device mesh gets one upload that
    feeds all its shards): yields (i, packed per shard, extraction
    keywords per shard, n_valid per shard), ``_pack_shards``'s. A process
    fills and uploads only the rows of its own shards. Only the short tail
    batch is padded; n_valid masks the padding. ``h2d_bytes_reads`` counts
    the bytes this process sent into ``metrics``; a falsy ``metrics`` is
    taken on purpose as None, a throwaway Metrics, because
    ``benchmark/tests/test_bench_sharded.py`` still passes ``False`` (this
    slot's former ``any_invalid``) positionally."""
    b, length = reads.shape
    local_rows = plan.per_dev * mesh.local_size
    metrics = metrics or Metrics()

    def fill(i, planes):
        start = i * plan.batch_total + mesh.first_shard * plan.per_dev
        rows = reads[start : start + local_rows]
        planes[0][: rows.shape[0]] = rows
        planes[0][rows.shape[0] :] = 0
        return local_rows

    targets = (
        [(mesh.devices[0], local_rows)] if mesh.single_device
        else [(dev, plan.per_dev) for dev in mesh.devices]
    )
    ring = UploadRing(targets, [length], depth=DIST_UPLOAD_PREFETCH,
                      pipelined=pipelined, metrics=metrics)
    with ring:
        for i, blocks in ring.stream(first, plan.num_batches, fill):
            metrics.count("h2d_bytes_reads", local_rows * length)
            packed, ext = _pack_shards(mesh, [blk[0] for blk in blocks],
                                       plan.per_dev)
            start = i * plan.batch_total
            n_valid = [
                int(min(max(b - start - plan.per_dev * s, 0), plan.per_dev))
                for s in mesh.local_shards
            ]
            yield i, packed, ext, n_valid


def _stream_batch(mesh: Mesh, reads: np.ndarray, plan: _StreamPlan, i: int):
    """Batch ``i`` alone, by a plain upload (for probes and checks):
    (packed per shard, extraction keywords per shard, n_valid)."""
    batches = _stream_batches(mesh, reads, plan, i, pipelined=False)
    try:
        return next(batches)[1:]
    finally:
        batches.close()


def _run_distributed_stream(
    reads: np.ndarray, cfg: AssemblyConfig, mesh: Mesh,
    bucket_cap: int | None, minimizer_len: int | None,
    table_capacity: int | None, metrics: Metrics | None = None,
    stream_checkpoint: str | None = None, stream_checkpoint_every: int = 0,
    resume_stream_from: str | None = None, *, abort_after_batch: int = 0,
    bucketed: str = "auto", merge_stride: int | None = None,
    _buckets: int | None = None, _bucket_accum: int | None = None,
) -> list[CountTable]:
    """Stream batches of ``cfg.batch_reads`` global reads through
    :func:`make_distributed_stream_step` into carried per-shard tables
    (``ops.stream_table.CarriedTable``, one a local shard).

    table_capacity bounds the GLOBAL unique k-mers; each shard gets
    capacity/D with hash-skew slack on the snug grid. Routing and table
    overflow accumulate on the device and raise after the last batch.
    bucketed / _buckets / _bucket_accum / merge_stride: the shard tables'
    layout and merge cadence, by the single device's rule
    (``models.pipeline.count_reads_device``); the result is the same table
    either way.

    stream_checkpoint + stream_checkpoint_every=N snapshot the shard
    tables and the batch cursor once N batches have passed (in the
    bucketed layout or under a stride: at the next merge);
    resume_stream_from continues from such a snapshot (same mesh size, k,
    batching, capacity, stride, routing and layout, enforced). A bucketed
    snapshot that would drop keys of a shard's exact hash table raises on
    every rank, as on one device.
    abort_after_batch=n raises after n batches of this call (the tests'
    stand-in for a killed run).
    """
    d = axis_size(mesh)
    b, length = reads.shape
    plan = _StreamPlan(b, length, cfg, d, bucket_cap, minimizer_len,
                       table_capacity, bucketed, _buckets, _bucket_accum,
                       merge_stride)
    if metrics is not None and merge_stride is not None:
        metrics.count("merge_stride", plan.stride)
    a2a_step = _a2a_count_bytes_per_step(d, cfg.k, plan.bucket_cap,
                                         minimizer_len)
    step = make_distributed_stream_step(mesh, cfg.k, length, plan.bucket_cap,
                                        minimizer_len)
    start_batch = 0
    tables = [None] * mesh.local_size
    if resume_stream_from is not None:
        arrays, start_batch, got = load_sharded_stream_checkpoint(
            resume_stream_from
        )
        if got != plan.ck_params:
            raise ValueError(
                f"sharded mid-stream checkpoint mismatch: saved {got}, this "
                f"run has {plan.ck_params}; resume requires identical mesh "
                "size/k/batching/capacity/routing/layout/read set"
            )
        tables = _tables_from_arrays(arrays, mesh, plan.c_shard)
    carried = [
        CarriedTable(plan.c_shard, n_limbs(cfg.k), dev, plan.buckets,
                     plan.stride, plan.stride * plan.recv, table)
        for dev, table in zip(mesh.devices, tables)
    ]

    def save(next_batch):
        snaps = [c.snapshot() for c in carried]
        if bool(any_reduce(mesh, [drops for _, drops in snaps])):
            raise RuntimeError(SNAPSHOT_DROPS)
        save_sharded_stream_checkpoint(
            [table for table, _ in snaps], stream_checkpoint, cfg.k,
            next_batch=next_batch, params=plan.ck_params, mesh=mesh,
        )

    cursor = StreamCursor(
        start_batch, plan.num_batches, every=stream_checkpoint_every,
        save=None if stream_checkpoint is None else save,
        abort_after_batch=abort_after_batch,
    )
    for i, packed, ext, n_valid in _stream_batches(
        mesh, reads, plan, start_batch, metrics
    ):
        step(carried, packed, n_valid, ext)
        if metrics is not None:
            metrics.count("a2a_bytes_count", a2a_step)
        cursor.after(i, all(c.at_boundary for c in carried))
    count_hash_use(metrics, carried)
    tables = [c.finish() for c in carried]
    if bool(any_reduce(mesh, [t.overflow for t in tables])):
        raise RuntimeError(
            "distributed streaming overflow (routing bucket or table "
            "shard); increase table_capacity / bucket_cap (a bucketed "
            "shard table: or take bucketed='off')"
        )
    return tables


def _run_distributed_step(
    reads: np.ndarray, cfg: AssemblyConfig, mesh: Mesh,
    bucket_cap: int | None = None, minimizer_len: int | None = None,
    table_capacity: int | None = None, metrics: Metrics | None = None,
    stream_checkpoint: str | None = None, stream_checkpoint_every: int = 0,
    resume_stream_from: str | None = None, *, abort_after_batch: int = 0,
    bucketed: str = "auto", merge_stride: int | None = None,
    _buckets: int | None = None, _bucket_accum: int | None = None,
) -> list[CountTable]:
    """Count over the mesh -> per-shard tables. Streams once a shard's
    window count exceeds DIST_STREAM_WINDOWS (or to resume); below it one
    step counts the whole read set, and the streaming checkpoint, layout
    and stride options do not apply."""
    d = axis_size(mesh)
    b, length = reads.shape
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    per_dev = -(-b // d)
    if (
        per_dev * (length - cfg.k + 1) > DIST_STREAM_WINDOWS
        or resume_stream_from is not None
    ):
        return _run_distributed_stream(
            reads, cfg, mesh, bucket_cap, minimizer_len, table_capacity,
            metrics, stream_checkpoint, stream_checkpoint_every,
            resume_stream_from, abort_after_batch=abort_after_batch,
            bucketed=bucketed, merge_stride=merge_stride, _buckets=_buckets,
            _bucket_accum=_bucket_accum,
        )
    if per_dev * d != b:
        reads = np.concatenate(
            [reads, np.zeros((per_dev * d - b, length), dtype=np.uint8)]
        )
    n_valid = [int(min(max(b - per_dev * s, 0), per_dev))
               for s in mesh.local_shards]
    if bucket_cap is None:
        bucket_cap = _bucket_cap_for(
            per_dev * (length - cfg.k + 1), d, cfg.k, minimizer_len
        )
    step = make_distributed_count(
        mesh, cfg.k, per_dev, length, bucket_cap, minimizer_len
    )
    packed, ext = _upload_shards(mesh, reads, per_dev, metrics)
    if metrics is not None:
        metrics.count(
            "a2a_bytes_count",
            _a2a_count_bytes_per_step(d, cfg.k, bucket_cap, minimizer_len),
        )
    tables, overflow = step(packed, n_valid, ext)
    if bool(overflow):
        raise RuntimeError(
            "bucket overflow during all-to-all routing; increase bucket_cap"
        )
    return tables


def distributed_count_table(
    reads: np.ndarray, cfg: AssemblyConfig, mesh: Mesh, *,
    bucket_cap: int | None = None, minimizer_len: int | None = None,
    table_capacity: int | None = None, metrics: Metrics | None = None,
    stream_checkpoint: str | None = None, stream_checkpoint_every: int = 0,
    resume_stream_from: str | None = None, abort_after_batch: int = 0,
    bucketed: str = "auto", merge_stride: int | None = None,
    _buckets: int | None = None, _bucket_accum: int | None = None,
) -> CountTable:
    """Count reads over the mesh; merge the shard tables into one
    CountTable on shard 0's device. ``bucketed`` (and its private knobs)
    and ``merge_stride`` pick the streamed shard tables' layout and merge
    cadence (``_run_distributed_stream``).

    Shards own disjoint hash classes, not key ranges, so the gathered
    rows re-count once with their counts as weights: a re-sort into the
    global order, sized by the genome's unique k-mers. The result equals
    the single-device ``count_reads_device`` table up to ``num_unique``.
    Across processes every rank receives the gathered rows and holds the
    same table on its first device (the reference's hosts all run the
    tail and all end with the same contigs).
    """
    tables = _run_distributed_step(
        reads, cfg, mesh, bucket_cap, minimizer_len, table_capacity, metrics,
        stream_checkpoint, stream_checkpoint_every, resume_stream_from,
        abort_after_batch=abort_after_batch, bucketed=bucketed,
        merge_stride=merge_stride, _buckets=_buckets,
        _bucket_accum=_bucket_accum,
    )
    limbs = all_gather(mesh, [t.limbs for t in tables])
    counts = all_gather(mesh, [t.counts for t in tables])
    if metrics is not None:
        metrics.count(
            "gather_bytes_table",
            limbs.element_size() * limbs.numel()
            + counts.element_size() * counts.numel(),
        )
    return count_torch.count_keys(limbs, counts)


def assemble_distributed(
    reads: np.ndarray,
    cfg: AssemblyConfig,
    mesh: Mesh | None = None,
    *,
    metrics: Metrics | None = None,
    emit: str = "unitigs",
    checkpoint: str | None = None,
    resume_from: str | None = None,
    return_graph: bool = False,
    minimizer_len: int | None = None,
    table_capacity: int | None = None,
    stream_checkpoint_every: int = 0,
    bucketed: str = "auto",
    merge_stride: int | None = None,
):
    """End-to-end assembly with the count sharded over ``mesh`` (default:
    one shard per visible GPU): the gathered genome-sized table then runs
    the single-device graph stages on shard 0's device. Contigs equal
    ``assemble_torch``'s, the reference's ``assemble_distributed``'s and
    the oracle's. Across processes every rank runs the graph stages on
    the same gathered table and returns the same contigs; rank 0 writes
    ``checkpoint``.

    checkpoint/resume_from: the gathered table as a stage-boundary .npz
    (either package's format). With stream_checkpoint_every=N > 0 the
    streaming counter also snapshots the shard tables and the batch
    cursor to ``checkpoint`` every N batches; resume_from detects such a
    snapshot and continues counting from it. bucketed, merge_stride: the
    streamed shard tables' layout (``"auto"``, ``"on"``, ``"off"``) and
    merge cadence; the same table either way.
    """
    if emit not in ("unitigs", "euler"):
        raise ValueError(f"emit must be 'unitigs' or 'euler', got {emit!r}")
    m = metrics if metrics is not None else Metrics()
    mesh = mesh if mesh is not None else build_mesh()
    dev = mesh.devices[0]
    m.count("reads", reads.shape[0])
    m.count("kmers", reads.shape[0] * (reads.shape[1] - cfg.k + 1))
    m.count("hosts", num_hosts(mesh))
    m.count("shards", axis_size(mesh))
    resume_stream = (
        resume_from is not None and is_sharded_stream_checkpoint(resume_from)
    )
    if resume_from is not None and not resume_stream:
        table = load_table(resume_from, dev)
    else:
        with _stage(m, "count", mesh):
            table = distributed_count_table(
                reads, cfg, mesh, minimizer_len=minimizer_len,
                table_capacity=table_capacity, metrics=m,
                stream_checkpoint=(
                    checkpoint if stream_checkpoint_every > 0 else None
                ),
                stream_checkpoint_every=stream_checkpoint_every,
                resume_stream_from=resume_from if resume_stream else None,
                bucketed=bucketed, merge_stride=merge_stride,
            )
    out = assemble_from_table(
        table, cfg, m, dev, emit=emit,
        checkpoint=checkpoint if is_writer(mesh) else None,
        return_graph=return_graph, after_stage=lambda: barrier(mesh),
    )
    barrier(mesh)  # the table's checkpoint is there on every rank's return
    return out


def _stage(m: Metrics, name: str, mesh: Mesh):
    """``timed_stage`` over the local shards' devices, closed by a barrier
    of the mesh (the span ``shard.barrier`` inside ``<name>.sync``: this
    process's wait for the slowest): a stage's seconds are the slowest
    process's."""

    def after():
        with m.span("shard.barrier"):
            barrier(mesh)

    return timed_stage(m, name, mesh.devices, after=after)


def _shard_filter_compact(tables: list[CountTable],
                          min_count: int) -> list[CountTable]:
    """Per-shard coverage filter + front compaction (no communication):
    the rows counted at least ``min_count`` times stay, in order, at the
    front of each shard; sentinel rows with count 0 fill the rest."""
    out = []
    for t in tables:
        keep = t.counts >= min_count
        out.append(CountTable(
            limbs=compact_front_sorted(keep, t.limbs, SENTINEL),
            counts=compact_front_sorted(keep, t.counts, 0),
            num_unique=keep.sum(),
            overflow=t.overflow,
        ))
    return out


def _shard_hist(mesh: Mesh, tables: list[CountTable]) -> np.ndarray:
    """Multiplicity histogram summed over all D shards, the auto
    threshold's input (the same number on every process): each shard's
    1001 bins cross to the host, no count column."""
    return sum(
        h.astype(np.int64) for h in gather_to_host(
            mesh, [count_torch.multiplicity_histogram(t) for t in tables])
    )


def filter_shards(mesh: Mesh, tables: list[CountTable], cfg: AssemblyConfig):
    """The sharded graph's filter stage: the coverage filter (``cfg.min_count``,
    or the threshold of the histogram summed over all D shards), then every
    shard cut to one snug capacity, the same on every process. Returns
    (tables, c_shard, min_count)."""
    min_count = cfg.min_count or auto_min_count_hist(_shard_hist(mesh, tables))
    tables = _shard_filter_compact(tables, min_count)
    kept = int(max_reduce(mesh, [t.num_unique for t in tables]))
    cap = max(t.limbs.shape[0] for t in tables)
    if mesh.distributed:
        cap = int(max_reduce(mesh, [torch.tensor(cap, device=mesh.devices[0])]))
    c_shard = min(cap, snug_capacity(kept))
    return ([count_torch.resize_table(t, c_shard) for t in tables], c_shard,
            min_count)


def save_sharded_table(tables: list[CountTable], d: int, k: int,
                       path: str, mesh: Mesh | None = None) -> None:
    """Checkpoint the hash-sharded count table in the reference's layout
    (``"hash_shards"``: uint32 words [D*C, W], int32 counts [D*C], d, k);
    either package resumes it on a mesh of D shards. ``tables`` are the
    local shards of ``mesh`` (None: all of them); across processes rank 0
    writes the one file of all D shards."""
    parts = _tables_to_host(mesh, tables, k)
    _write_shared(
        mesh, path,
        words=np.concatenate([p[0] for p in parts]),
        counts=np.concatenate([p[1] for p in parts]),
        d=np.asarray(d),
        k=np.asarray(k),
        layout=np.asarray("hash_shards"),
    )


def load_sharded_table(path: str, mesh: Mesh, k: int) -> list[CountTable]:
    """Restore a sharded-table checkpoint onto the mesh's local shards
    (every process reads the file and keeps its rows); its D and k must
    be this run's."""
    require_checkpoint_kind(path, "sharded_table")
    d = axis_size(mesh)
    with np.load(path) as z:
        if str(z["layout"]) != "hash_shards":
            raise ValueError(f"{path}: not a sharded-table checkpoint")
        if int(z["d"]) != d or int(z["k"]) != k:
            raise ValueError(
                f"{path}: checkpoint is for d={int(z['d'])}, k={int(z['k'])};"
                f" this run has d={d}, k={k}"
            )
        words = z["words"].reshape(d, -1, z["words"].shape[1])
        counts = z["counts"].reshape(d, -1)
    return [
        count_torch.count_table_from_numpy(
            words[s], counts[s],
            int((words[s] != np.uint32(0xFFFFFFFF)).any(axis=1).sum()),
            False, device=dev,
        )
        for s, dev in zip(mesh.local_shards, mesh.devices)
    ]


def assemble_distributed_sharded(
    reads: np.ndarray,
    cfg: AssemblyConfig,
    mesh: Mesh | None = None,
    *,
    metrics: Metrics | None = None,
    emit: str = "unitigs",
    bucket_cap: int | None = None,
    checkpoint: str | None = None,
    resume_from: str | None = None,
    return_graph: bool = False,
    minimizer_len: int | None = None,
    table_capacity: int | None = None,
    stream_checkpoint_every: int = 0,
    bucketed: str = "auto",
    merge_stride: int | None = None,
):
    """Fully sharded assembly: the graph never gathers onto one device.

    Counting, filtering, edge building, successor linking, pointer
    doubling, numbering and spelling all run shard-wise over ``mesh``
    (``parallel/compress.py``); per-device memory scales ~1/D and the
    host receives only packed bases and per-unitig rows. Requires odd k.
    Contigs equal ``assemble_distributed``'s, the reference's and the
    oracle's. Across processes every rank ends with the same unitig
    arrays on its host and returns the same contigs.

    checkpoint/resume_from: the pre-filter hash-sharded count table as
    .npz (``"hash_shards"``, either package's; the mesh size and k must
    match on resume). With stream_checkpoint_every=N > 0 the streaming
    counter also snapshots the shard tables and the batch cursor to
    ``checkpoint`` every N batches; resume_from detects such a snapshot
    and continues counting from it. bucketed, merge_stride: the streamed
    shard tables' layout and merge cadence, as in
    ``assemble_distributed``.
    """
    if cfg.k % 2 == 0:
        raise ValueError("sharded compression requires odd k")
    if emit not in ("unitigs", "euler"):
        raise ValueError(f"emit must be 'unitigs' or 'euler', got {emit!r}")
    m = metrics if metrics is not None else Metrics()
    mesh = mesh if mesh is not None else build_mesh()
    d = axis_size(mesh)
    m.count("reads", reads.shape[0])
    m.count("kmers", reads.shape[0] * (reads.shape[1] - cfg.k + 1))
    m.count("hosts", num_hosts(mesh))
    m.count("shards", d)
    resume_stream = (
        resume_from is not None and is_sharded_stream_checkpoint(resume_from)
    )
    if resume_from is not None and not resume_stream:
        tables = load_sharded_table(resume_from, mesh, cfg.k)
    else:
        with _stage(m, "count", mesh):
            tables = _run_distributed_step(
                reads, cfg, mesh, bucket_cap, minimizer_len, table_capacity,
                m, checkpoint if stream_checkpoint_every > 0 else None,
                stream_checkpoint_every,
                resume_from if resume_stream else None,
                bucketed=bucketed, merge_stride=merge_stride,
            )
    if checkpoint is not None:
        save_sharded_table(tables, d, cfg.k, checkpoint, mesh)

    with _stage(m, "filter", mesh):
        tables, c_shard, min_count = filter_shards(mesh, tables, cfg)

    with _stage(m, "compress", mesh):
        wire = wire_bytes(d, cfg.k, c_shard)
        m.count("a2a_bytes_compress_link", wire["link"])
        m.count("a2a_bytes_compress_query_round", wire["query_round"])
        m.count("a2a_compress_query_rounds_max",
                comm_bytes_estimate(d, cfg.k, c_shard)["query_rounds_max"])
        g = make_sharded_compress(mesh, cfg.k, c_shard)(tables)
        m.count("a2a_compress_query_rounds", g.query_rounds)
        m.count("compress_doubling_rounds", g.doubling_rounds)
        m.count("compress_doubling_s", g.doubling_seconds)
        if g.overflow:
            which = [name for bit, name in OVERFLOW_CAPS if g.overflow & bit]
            raise RuntimeError(
                "sharded compression routing overflow in "
                f"{'+'.join(which)} (bits {g.overflow}); increase the "
                "corresponding slack cap (parallel/compress.py)"
            )
    with _stage(m, "spell", mesh):
        ua = spell_sharded_arrays(
            mesh, cfg.k, c_shard, g.num_unitigs, g.valid, g.uid, g.pos,
            g.cov, g.heads, g.edge_limbs, metrics=m,
        )
    with _stage(m, "simplify", mesh):
        graph = simplify_arrays_to_graph(
            ua, cfg.resolved_tip_len, cfg.resolved_bubble_len, min_count
        )
    with _stage(m, "traverse", mesh), counted_into(m):
        contigs = (
            emit_contigs_euler(graph) if emit == "euler" else emit_contigs(graph)
        )
    return (contigs, graph) if return_graph else contigs
