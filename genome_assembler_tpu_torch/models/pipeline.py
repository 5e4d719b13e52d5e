"""Single-device assembly pipeline in PyTorch.

Counterpart of ``genome_assembler_tpu/models/pipeline.py::assemble_tpu``:

  2-bit-packed reads -> canonical k-mers   ops.kmer_torch (CUDA kernel)
  count (single shot or flat streaming)    ops.count_torch
  compaction + coverage filter             ops.count_torch
  unitig compression (odd k)               ops.unitig_torch
  spelling reduction                       ops.unitig_torch + host.dbg
  simplification + traversal               the port's own NumPy host
                                           modules (host.*)

Reads cross to the device as raw one-byte codes and are packed there (4
bases per byte, ambiguous bases as a separate bit plane) for the kernel;
everything from the pack to the spelling reduction stays on the device.
The streaming counter uploads through ``utils.upload.UploadRing``: pinned
host slots, a copy stream, two batches queued ahead of the one being
counted, and nothing between two batches that waits for the device.
Even k takes the reference's host-dict graph branch. The streaming
counter can snapshot its table and batch cursor mid-stream and resume
from such a snapshot, in the reference's format.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..host.dbg import counts_to_dict
from ..host.simplify import simplify_counts
from ..host.simplify_arrays import simplify_arrays_to_graph
from ..host.traverse import emit_contigs, emit_contigs_euler
from ..utils.config import AssemblyConfig
from ..utils.dna import has_ambiguous
from ..utils.metrics import Metrics, log

from ..host.dbg import spell_device_arrays
from ..ops import count_torch
from ..ops.count_torch import CountTable
from ..ops.kmer_torch import (
    extract_canonical_flat,
    pack_codes_device,
    pack_invalid_device,
)
from ..ops.unitig_torch import compress_unitigs_device
from ..utils.device import resolve_device, synchronize
from ..utils.keys import limbs_to_words, n_limbs
from ..utils.upload import UploadRing

# Above this many windows the counter streams batches into a bounded
# table instead of counting all windows in one shot (the reference's
# default, pipeline.py SINGLE_SHOT_WINDOWS).
SINGLE_SHOT_WINDOWS = 1 << 27
# Batches uploaded ahead of the one being counted (the reference's
# prefetch depth).
UPLOAD_PREFETCH = 2


@contextlib.contextmanager
def timed_stage(m: Metrics, name: str, devices):
    """Wall time of one stage, closed by a synchronise of ``devices`` (one
    device or several; every stream of each, the copy streams too) so
    queued work is charged to the stage that queued it. The stage is a
    ``record_function`` span of a profiler trace."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
        if isinstance(devices, torch.device):
            devices = [devices]
        for dev in dict.fromkeys(devices):
            synchronize(dev)
    dt = time.perf_counter() - t0
    m.stages[name] = m.stages.get(name, 0.0) + dt
    log.debug("stage %s: %.3fs", name, dt)


def pack_on_device(codes: torch.Tensor, has_invalid: bool):
    """Raw [B, L] codes on their device -> (packed codes, invalid bits or
    None): the kernel's inputs. The one pack route of the port: the bytes
    equal ``utils.dna.pack_codes`` / ``pack_invalid_mask`` of the same rows."""
    return (
        pack_codes_device(codes),
        pack_invalid_device(codes) if has_invalid else None,
    )


def _count_batch(
    packed: torch.Tensor,
    read_len: int,
    k: int,
    inv_bits: torch.Tensor | None = None,
    out_cap: int | None = None,
) -> CountTable:
    """Extract + canonicalize + sort-count one packed read batch; out_cap
    truncates (flagging overflow) or pads the table to that capacity."""
    keys = extract_canonical_flat(packed, read_len, k, inv_bits=inv_bits)
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
) -> CountTable:
    """Count one batch into the running table: the raw canonical key
    stream weighted-merges straight into it (``merge_raw_keys``)."""
    keys = extract_canonical_flat(packed, read_len, k, inv_bits=inv_bits)
    return count_torch.merge_raw_keys(table, keys)


def save_stream_checkpoint(
    table: CountTable, path: str, k: int, *, next_start: int,
    params: dict[str, int],
) -> None:
    """Mid-stream checkpoint: the carried table and the batch cursor, in
    the reference's format (``models/pipeline.py save_stream_checkpoint``:
    uint32 words, int32 counts, num_unique, overflow, next_start and the
    run's ``params``), so either package resumes the other's. ``params``
    pins everything the resumed table depends on; a resume refuses a
    mismatch."""
    words, counts, num, over = count_torch.count_table_to_numpy(table, k)
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


def after_stream_batch(
    i: int, start: int, n: int, *, every: int, save, abort_after_batch: int
) -> None:
    """The cursor policy of both streaming counters, run after batch ``i``
    of ``n`` in a call that began at batch ``start``: every ``every``
    batches of the call, bar the last batch, ``save(i + 1)`` snapshots
    (``save`` None: no snapshots); after ``abort_after_batch`` batches of
    the call it raises (the tests' stand-in for a killed run)."""
    done = i + 1 - start
    if save is not None and every > 0 and done % every == 0 and i + 1 < n:
        save(i + 1)
    if abort_after_batch and done >= abort_after_batch:
        raise RuntimeError(
            f"fault injection: abort_after_batch={abort_after_batch} "
            f"reached at batch {i + 1}/{n}"
        )


def load_stream_checkpoint(
    path: str, device: torch.device | str
) -> tuple[CountTable, int, dict[str, int]]:
    """-> (carried table on ``device``, next_start, params)."""
    require_checkpoint_kind(path, "stream")
    table_keys = ("words", "counts", "num_unique", "overflow")
    with np.load(path) as z:
        table = count_torch.count_table_from_numpy(
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
    _plain_upload: bool = False,
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

    stream_checkpoint + stream_checkpoint_every=N: every N streamed
    batches, snapshot the carried table and the batch cursor to
    ``stream_checkpoint``; resume_stream_from continues from such a
    snapshot (written by either package) to the same table as an
    uninterrupted run. The snapshot's k, batch, capacity and read count
    must match this run's. abort_after_batch=n raises after n batches of
    this call (the tests' stand-in for a killed run).
    """
    device = resolve_device(device)
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    b, length = reads.shape
    total_windows = b * (length - cfg.k + 1)
    has_invalid = has_ambiguous(reads)

    if table_capacity is None and total_windows <= SINGLE_SHOT_WINDOWS:
        if resume_stream_from is not None:
            raise ValueError(
                "resume_stream_from requires the streaming path; pass the "
                "table_capacity the checkpointed run used"
            )
        packed, inv = pack_on_device(
            torch.from_numpy(reads).to(device), has_invalid
        )
        return _count_batch(packed, length, cfg.k, inv)

    capacity = table_capacity or min(total_windows, SINGLE_SHOT_WINDOWS)
    batch = cfg.batch_reads
    starts = range(0, b, batch)
    # everything the carried table depends on; the reference's keys, with
    # its flat merge (stride 1, not bucketed)
    ck_params = {
        "k": cfg.k, "batch": batch, "capacity": capacity, "stride": 1,
        "total_reads": b, "bucketed": 0,
    }
    table = None
    start_idx = 0
    if resume_stream_from is not None:
        table, next_start, got = load_stream_checkpoint(
            resume_stream_from, device
        )
        if got != ck_params:
            raise ValueError(
                f"mid-stream checkpoint mismatch: saved {got}, this run has "
                f"{ck_params}; resume requires identical k/batch/capacity/"
                "read set"
            )
        start_idx = next_start // batch
    def save(next_batch):
        save_stream_checkpoint(
            table, stream_checkpoint, cfg.k, next_start=starts[next_batch],
            params=ck_params,
        )

    def fill(i, planes):
        rows = reads[starts[i] : starts[i] + batch]
        planes[0][: rows.shape[0]] = rows
        return rows.shape[0]

    ring = UploadRing(
        [(device, min(batch, b))], [length], depth=UPLOAD_PREFETCH,
        pipelined=False if _plain_upload else None,
    )
    with ring:
        for i, [[codes]] in ring.stream(start_idx, len(starts), fill):
            packed, inv = pack_on_device(codes, has_invalid)
            if table is None:
                table = _count_batch(packed, length, cfg.k, inv,
                                     out_cap=capacity)
            else:
                table = _stream_step(table, packed, length, cfg.k, inv)
            # the table after batch i, whatever is already uploaded
            after_stream_batch(
                i, start_idx, len(starts), every=stream_checkpoint_every,
                save=None if stream_checkpoint is None else save,
                abort_after_batch=abort_after_batch,
            )
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
):
    """The back half shared by ``assemble_torch`` and the sharded
    ``assemble_distributed``: counted table on ``dev`` -> (stage-boundary
    checkpoint) -> coverage filter -> unitigs -> simplified graph ->
    contigs."""
    if table.limbs.shape[1] != n_limbs(cfg.k):
        raise ValueError(
            f"the table holds keys of another k ({table.limbs.shape[1]} "
            f"limb(s), k={cfg.k} needs {n_limbs(cfg.k)})"
        )
    if checkpoint is not None:
        save_table(table, checkpoint, cfg.k)
    min_count = cfg.min_count or auto_min_count(table)
    with timed_stage(m, "filter", dev):
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
        with timed_stage(m, "compress", dev):
            dev_unitigs = compress_unitigs_device(table, cfg.k)
        with timed_stage(m, "spell", dev):
            ua = spell_device_arrays(dev_unitigs, cfg.k)
        with timed_stage(m, "simplify", dev):
            graph = simplify_arrays_to_graph(
                ua, cfg.resolved_tip_len, cfg.resolved_bubble_len, min_count
            )
    else:
        # even k: palindromic k-mers rule out device compression; the
        # reference's host-dict graph branch
        with timed_stage(m, "host_graph", dev):
            counts = table_to_host_counts(table, cfg.k)
            graph = simplify_counts(
                counts, cfg.k, cfg.resolved_tip_len,
                cfg.resolved_bubble_len, min_count,
            )
    with timed_stage(m, "traverse", dev):
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
):
    """End-to-end single-device assembly: reads -> canonical contigs.

    device: ``"cuda"`` (default) or ``"cpu"``; CUDA that is not there is
    an error, never a silent CPU run. checkpoint/resume_from: the counted
    table as a stage-boundary .npz (either package's format). With
    stream_checkpoint_every=N > 0 the streaming counter also snapshots
    its table and batch cursor to ``checkpoint`` every N batches;
    resume_from detects such a snapshot and continues counting from it.
    emit: ``"unitigs"`` stops contigs at junctions, ``"euler"`` spells
    Eulerian walks. Contigs equal ``assemble_tpu``'s and
    ``assemble_oracle``'s.
    """
    dev = resolve_device(device)
    if emit not in ("unitigs", "euler"):
        raise ValueError(f"emit must be 'unitigs' or 'euler', got {emit!r}")
    m = metrics if metrics is not None else Metrics()
    wc = reads.shape[1] - cfg.k + 1
    m.count("reads", reads.shape[0])
    m.count("kmers", reads.shape[0] * wc)
    if has_ambiguous(reads):
        from ..ops.kmer_ref import window_valid_np

        m.count("masked_windows", int((~window_valid_np(reads, cfg.k)).sum()))
    resume_stream = (
        resume_from is not None and is_stream_checkpoint(resume_from)
    )
    if resume_from is not None and not resume_stream:
        table = load_table(resume_from, dev)
    else:
        with timed_stage(m, "count", dev):
            table = count_reads_device(
                reads, cfg, device=dev, table_capacity=table_capacity,
                stream_checkpoint=(
                    checkpoint if stream_checkpoint_every > 0 else None
                ),
                stream_checkpoint_every=stream_checkpoint_every,
                resume_stream_from=resume_from if resume_stream else None,
            )
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
