"""The streamed count's upload path on the CPU: the device pack's bytes
against the JAX package's host pack, the upload ring's cursor logic, and
the streamed counters (one device and sharded) against the JAX package's
and the single-shot table. Exact equality everywhere (bytes, integers).
The pinned, copy-stream route runs only on a card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

import genome_assembler_tpu.parallel.pipeline as jax_pp
import genome_assembler_tpu_torch.parallel.pipeline as pp
from genome_assembler_tpu.models import pipeline as jax_pipeline
from genome_assembler_tpu.parallel.mesh import build_mesh as jax_mesh
from genome_assembler_tpu.parallel.mesh import mesh_axes
from genome_assembler_tpu.utils.config import AssemblyConfig
from genome_assembler_tpu.utils.dna import pack_codes, pack_invalid_mask
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads
from genome_assembler_tpu_torch.models import pipeline
from genome_assembler_tpu_torch.ops import count_torch, kmer_torch
from genome_assembler_tpu_torch.parallel.mesh import build_mesh
from genome_assembler_tpu_torch.utils.keys import limbs_to_words
from genome_assembler_tpu_torch.utils.metrics import Metrics
from genome_assembler_tpu_torch.utils.upload import UploadRing

torch.set_num_threads(1)

K = 15
CAP = 8192


def _reads(n_rate=0.004, seed=91, drop=0):
    genome = simulate_genome(2000, seed=seed)
    codes = simulate_reads(genome, coverage=12, read_len=60,
                           seed=seed + 1).codes.copy()
    if n_rate:
        codes[np.random.default_rng(seed).random(codes.shape) < n_rate] = 4
    return codes[: codes.shape[0] - drop]


@pytest.fixture(scope="module")
def reads():
    return _reads()  # 400 reads of 60 bp, Ns present


# --------------------------------------------------------------- the pack

@pytest.mark.parametrize("length", [99, 100, 101, 250])
def test_device_pack_bytes_equal_the_reference(length):
    rng = np.random.default_rng(length)
    codes = rng.integers(0, 4, size=(37, length), dtype=np.uint8)
    batches = torch.zeros((), dtype=torch.int64)
    packed, zeros, flag = pipeline.pack_on_device(torch.from_numpy(codes),
                                                  batches)
    assert packed.dtype == torch.uint8
    assert packed.is_contiguous()
    np.testing.assert_array_equal(packed.numpy(), pack_codes(codes))
    # no ambiguous base: the reference sends no bits, the port zeros and
    # a flag at 0
    assert pack_invalid_mask(codes) is None
    assert zeros.shape == (37, (length + 7) // 8) and not zeros.any()
    assert flag.dtype == torch.int32 and flag.shape == () and int(flag) == 0
    assert int(batches) == 0
    codes[rng.random(codes.shape) < 0.1] = 4
    codes[0, 0] = codes[1, -1] = 4
    codes[2, :] = 4
    packed, inv, flag = pipeline.pack_on_device(torch.from_numpy(codes),
                                                batches)
    np.testing.assert_array_equal(packed.numpy(), pack_codes(codes))
    np.testing.assert_array_equal(inv.numpy(), pack_invalid_mask(codes))
    assert inv.is_contiguous() and inv.dtype == torch.uint8
    assert int(flag) != 0 and int(batches) == 1
    # an N in the last base of the last row alone sets the flag
    clean = rng.integers(0, 4, size=(5, length), dtype=np.uint8)
    clean[-1, -1] = 5
    assert int(pipeline.pack_on_device(torch.from_numpy(clean),
                                       batches).flag) != 0
    assert int(batches) == 2
    # and the kernel's plain version reads them back as the same reads
    np.testing.assert_array_equal(
        kmer_torch.unpack_codes(packed, length).numpy(), codes & 3)
    np.testing.assert_array_equal(
        kmer_torch.unpack_invalid_mask(inv, length).numpy(), codes > 3)


# --------------------------------------------------------------- the ring

def _fill_from(data, batch):
    def fill(i, planes):
        rows = data[i * batch : (i + 1) * batch]
        planes[0][: len(rows)] = rows
        return len(rows)
    return fill


def test_ring_plain_route_hands_out_every_batch_in_order():
    data = np.arange(10 * 3, dtype=np.uint8).reshape(10, 3)
    ring = UploadRing([("cpu", 4)], [3])
    assert not ring.pipelined
    with ring:
        got = [(i, blocks[0][0].numpy().copy())
               for i, blocks in ring.stream(0, 3, _fill_from(data, 4))]
    assert [i for i, _ in got] == [0, 1, 2]
    np.testing.assert_array_equal(np.concatenate([g for _, g in got]), data)
    assert got[2][1].shape == (2, 3)  # the short last batch is not padded
    # a resume starts at its cursor
    with ring:
        assert [i for i, _ in ring.stream(2, 3, _fill_from(data, 4))] == [2]


def test_ring_splits_a_batch_over_its_targets():
    data = np.arange(12 * 2, dtype=np.uint8).reshape(12, 2)
    inv = data[:, :1] + 100
    ring = UploadRing([("cpu", 2), ("cpu", 2), ("cpu", 2)], [2, 1])

    def fill(i, planes):
        planes[0][:] = data[i * 6 : (i + 1) * 6]
        planes[1][:] = inv[i * 6 : (i + 1) * 6]
        return 6

    with ring:
        for i, blocks in ring.stream(0, 2, fill):
            assert len(blocks) == 3
            for t, (codes, bits) in enumerate(blocks):
                lo = i * 6 + 2 * t
                np.testing.assert_array_equal(codes.numpy(), data[lo : lo + 2])
                np.testing.assert_array_equal(bits.numpy(), inv[lo : lo + 2])


def test_ring_refuses_the_pipelined_route_off_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        UploadRing([("cpu", 4)], [3], pipelined=True)


@pytest.mark.parametrize("depth,first,n", [(2, 0, 7), (1, 0, 5), (2, 3, 9),
                                           (2, 0, 1), (3, 0, 4)])
def test_ring_prefetch_order(depth, first, n):
    """The pipelined route's cursor logic with the device calls replaced
    by a log: batch i+1 .. i+depth are submitted before batch i is handed
    out, no further, and a slot is submitted again only after its last
    batch was released."""
    ring = UploadRing([("cpu", 4)], [3], depth=depth)
    ring.pipelined = True
    ring._slots = [{"id": j} for j in range(depth + 1)]
    log = []
    holds = {}
    ring._submit = lambda i, fill, slot: (
        log.append(("submit", i)), holds.__setitem__(slot["id"], i))
    ring._hand_out = lambda slot: holds[slot["id"]]
    ring._release = lambda slot: log.append(("release", holds[slot["id"]]))
    for i, batch in ring.stream(first, n, None):
        assert batch == i
        log.append(("use", i))
    assert [e for e in log if e[0] == "use"] == [("use", i)
                                                 for i in range(first, n)]
    assert [e for e in log if e[0] == "submit"] == [
        ("submit", i) for i in range(first, n)]
    at = {e: pos for pos, e in enumerate(log)}
    for i in range(first, n):
        ahead = [j for j in range(first, n)
                 if at[("submit", j)] < at[("use", i)]]
        assert max(ahead) == min(i + depth, n - 1)
        if i + depth + 1 < n:  # the slot's next tenant waits for its release
            assert at[("release", i)] < at[("submit", i + depth + 1)]


# --------------------------------------------- the streamed count, one device

def _port_numpy(table):
    return count_torch.count_table_to_numpy(table, K)


@pytest.fixture(scope="module")
def single_shot(reads):
    cfg = AssemblyConfig(k=K, read_len=60)
    return _port_numpy(pipeline.count_reads_device(reads, cfg, device="cpu"))


@pytest.mark.parametrize("batch", [400, 150, 60],
                         ids=["1_batch", "3_batches", "7_batches"])
def test_streamed_count_equals_jax_and_single_shot(reads, single_shot, batch):
    cfg = AssemblyConfig(k=K, read_len=60, batch_reads=batch)
    assert -(-reads.shape[0] // batch) in (1, 3, 7)
    assert batch == 400 or reads.shape[0] % batch  # a short last batch
    got = _port_numpy(pipeline.count_reads_device(
        reads, cfg, device="cpu", table_capacity=CAP))
    want = jax_pipeline.count_reads_device(reads, cfg, table_capacity=CAP)
    n = int(want.num_unique)
    assert int(got[2]) == n and bool(got[3]) == bool(want.overflow) is False
    np.testing.assert_array_equal(got[0], np.asarray(want.words))
    np.testing.assert_array_equal(got[1], np.asarray(want.counts))
    assert int(single_shot[2]) == n
    np.testing.assert_array_equal(got[0][:n], single_shot[0][:n])
    np.testing.assert_array_equal(got[1][:n], single_shot[1][:n])
    # the plain route asked for by name is the same route on the CPU
    again = _port_numpy(pipeline.count_reads_device(
        reads, cfg, device="cpu", table_capacity=CAP, _plain_upload=True))
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)


def test_streamed_count_overflow_equals_jax(reads):
    cfg = AssemblyConfig(k=K, read_len=60, batch_reads=150)
    got = pipeline.count_reads_device(reads, cfg, device="cpu",
                                      table_capacity=512)
    want = jax_pipeline.count_reads_device(reads, cfg, table_capacity=512)
    assert bool(got.overflow) and bool(want.overflow)
    np.testing.assert_array_equal(_port_numpy(got)[0], np.asarray(want.words))


def test_streamed_count_of_clean_reads_sends_no_bits(monkeypatch):
    """Clean reads: every batch's flag is 0, so the kernel never reads
    the invalid bits (all zeros) that the pack wrote."""
    clean = _reads(n_rate=0.0)
    seen = []
    real = pipeline.extract_canonical_flat

    def spy(packed, read_len, k, n_valid=None, inv_bits=None, flag=None,
            masked=None):
        seen.append((int(flag), bool(inv_bits.any())))
        return real(packed, read_len, k, n_valid, inv_bits, flag, masked)

    monkeypatch.setattr(pipeline, "extract_canonical_flat", spy)
    cfg = AssemblyConfig(k=K, read_len=60, batch_reads=150)
    pipeline.count_reads_device(clean, cfg, device="cpu", table_capacity=CAP)
    assert seen == [(0, False)] * 3


COUNT_PATHS = {
    "single_shot": {},
    "flat": dict(table_capacity=CAP, bucketed="off"),
    "bucketed": dict(table_capacity=CAP, bucketed="on"),
    "stride2": dict(table_capacity=CAP, bucketed="off", merge_stride=2),
}


@pytest.mark.parametrize("n_rate", [0.004, 0.0], ids=["ns", "clean"])
@pytest.mark.parametrize("path", sorted(COUNT_PATHS))
def test_count_finds_ambiguous_bases_on_the_device(monkeypatch, path,
                                                   n_rate):
    """The pack finds the Ns batch by batch: no host scan of the reads
    (``has_ambiguous``, ``window_valid_np``) in ``assemble_torch`` or
    ``count_reads_device``; the table and the contigs equal the plain
    reference's; ``masked_windows`` and ``ambiguous_batches`` count what
    the host scan would have."""
    from genome_assembler_tpu_torch.host.dbg import counts_to_dict
    from genome_assembler_tpu_torch.models.oracle import assemble_oracle
    from genome_assembler_tpu_torch.ops import kmer_ref
    from genome_assembler_tpu_torch.utils import dna

    reads = _reads(n_rate=n_rate)
    second = reads[96:192]
    second[second > 3] = 0  # a streamed batch without an N among four with
    cfg = AssemblyConfig(k=K, read_len=60, batch_reads=96)
    kw = COUNT_PATHS[path]
    with_n = (4 if kw else 1) if n_rate else 0
    masked = int((~kmer_ref.window_valid_np(reads, K)).sum())
    assert (masked > 0) == bool(n_rate)
    want_table = counts_to_dict(*kmer_ref.count_canonical_np(reads, K), K)
    want_contigs = assemble_oracle(reads, cfg)

    def host_scan(*args, **kwargs):
        raise AssertionError("the reads were scanned on the host")

    monkeypatch.setattr(dna, "has_ambiguous", host_scan)
    monkeypatch.setattr(kmer_ref, "window_valid_np", host_scan)
    counts = torch.zeros(2, dtype=torch.int64)
    table = pipeline.count_reads_device(reads, cfg, device="cpu",
                                        ambiguous_counts=counts, **kw)
    assert pipeline.table_to_host_counts(table, K) == want_table
    assert counts.tolist() == [masked, with_n]
    m = Metrics()
    assert pipeline.assemble_torch(reads, cfg, device="cpu", metrics=m,
                                   **kw) == want_contigs
    assert m.counters["ambiguous_batches"] == with_n
    assert m.counters.get("masked_windows", 0) == masked
    assert ("masked_windows" in m.counters) == bool(n_rate)


SHARDED_PATHS = {
    "one_shot": ({}, {}),
    "flat": (dict(bucketed="off"), dict(GA_BUCKETED="0")),
    "bucketed": (dict(bucketed="on", _buckets=8, _bucket_accum=2),
                 dict(GA_BUCKETED="1", GA_BUCKETS="8", GA_BUCKET_ACCUM="2")),
    "stride2": (dict(bucketed="off", merge_stride=2), dict(GA_BUCKETED="0")),
}


@pytest.mark.parametrize("n_rate", [0.004, 0.0], ids=["ns", "clean"])
@pytest.mark.parametrize("path", sorted(SHARDED_PATHS))
def test_sharded_count_finds_ambiguous_bases_on_the_device(monkeypatch, path,
                                                           n_rate):
    """The sharded count takes its Ns from the pack's flag, as the single
    device does: on a 4-shard mesh, in one step or streamed (flat,
    bucketed, stride 2), no host pass scans the reads (``has_ambiguous``,
    also where ``parallel.pipeline`` would bind it, ``window_valid_np``);
    the shard tables equal the JAX package's and the contigs the
    oracle's."""
    from genome_assembler_tpu_torch.models.oracle import assemble_oracle
    from genome_assembler_tpu_torch.ops import kmer_ref
    from genome_assembler_tpu_torch.utils import dna

    reads = _reads(n_rate=n_rate)
    second = reads[96:192]
    second[second > 3] = 0  # a streamed batch without an N among four with
    cfg = AssemblyConfig(k=K, read_len=60, batch_reads=96)
    kw, jax_env = SHARDED_PATHS[path]
    if kw:  # the streamed count: 5 global batches of 24 reads a shard
        monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
        monkeypatch.setattr(jax_pp, "DIST_STREAM_WINDOWS", 0)
    want_contigs = assemble_oracle(reads, cfg)
    mesh = jax_mesh(4)
    with monkeypatch.context() as mp:
        for name, value in jax_env.items():
            mp.setenv(name, value)
        words, counts, num = jax_pp._run_distributed_step(
            reads, cfg, mesh, None, mesh_axes(mesh), None,
            table_capacity=CAP, merge_stride=kw.get("merge_stride"))
    words = np.asarray(words).reshape(4, -1, 1)
    counts = np.asarray(counts).reshape(4, -1)

    def host_scan(*args, **kwargs):
        raise AssertionError("the reads were scanned on the host")

    monkeypatch.setattr(dna, "has_ambiguous", host_scan)
    monkeypatch.setattr(pp, "has_ambiguous", host_scan, raising=False)
    monkeypatch.setattr(kmer_ref, "window_valid_np", host_scan)
    mesh = build_mesh(4, devices=["cpu"])
    tables = pp._run_distributed_step(reads, cfg, mesh, table_capacity=CAP,
                                      **kw)
    for s, t in enumerate(tables):
        n = int(t.num_unique)
        assert n == int(np.asarray(num)[s]) and n > 0 and not bool(t.overflow)
        np.testing.assert_array_equal(
            limbs_to_words(t.limbs[:n].numpy(), K), words[s, :n])
        np.testing.assert_array_equal(t.counts[:n].numpy(), counts[s, :n])
    m = Metrics()
    public = {name: v for name, v in kw.items() if not name.startswith("_")}
    assert pp.assemble_distributed_sharded(
        reads, cfg, mesh, table_capacity=CAP, metrics=m,
        **public) == want_contigs
    assert "shard.scan" not in m.spans


@pytest.mark.parametrize("resume", ["stream", "jax_stream", "table"])
def test_resumed_run_counts_the_ambiguous_bases_of_every_read(
        monkeypatch, tmp_path, resume):
    """``assemble_tpu`` counts the masked windows of every read whatever it
    resumes; so does the port, on the device: after a stream resume (its
    own checkpoint or the JAX package's) the batches before the cursor
    too, after a table resume all of them. No host scan either way."""
    from genome_assembler_tpu.utils.metrics import Metrics as JaxMetrics
    from genome_assembler_tpu_torch.ops import kmer_ref
    from genome_assembler_tpu_torch.utils import dna

    reads = _reads()
    cfg = AssemblyConfig(k=K, read_len=60, batch_reads=96)
    jm = JaxMetrics()
    want = jax_pipeline.assemble_tpu(reads, cfg, metrics=jm,
                                     table_capacity=CAP)
    with_n = sum(bool((reads[s : s + 96] > 3).any())
                 for s in range(0, reads.shape[0], 96))
    assert jm.counters["masked_windows"] > 0 and with_n == 5
    ck = str(tmp_path / "ck.npz")
    if resume == "stream":
        with pytest.raises(RuntimeError, match="fault injection"):
            pipeline.count_reads_device(
                reads, cfg, device="cpu", table_capacity=CAP,
                stream_checkpoint=ck, stream_checkpoint_every=1,
                abort_after_batch=2)
    elif resume == "jax_stream":
        with monkeypatch.context() as mp:
            mp.setenv("GA_STREAM_ABORT_AFTER_BATCH", "3")
            with pytest.raises(RuntimeError, match="fault injection"):
                jax_pipeline.count_reads_device(
                    reads, cfg, table_capacity=CAP, stream_checkpoint=ck,
                    stream_checkpoint_every=1)
    else:
        pipeline.assemble_torch(reads, cfg, device="cpu",
                                table_capacity=CAP, checkpoint=ck)
    assert pipeline.is_stream_checkpoint(ck) == (resume != "table")

    def host_scan(*args, **kwargs):
        raise AssertionError("the reads were scanned on the host")

    monkeypatch.setattr(dna, "has_ambiguous", host_scan)
    monkeypatch.setattr(kmer_ref, "window_valid_np", host_scan)
    m = Metrics()
    assert pipeline.assemble_torch(reads, cfg, device="cpu", metrics=m,
                                   table_capacity=CAP,
                                   resume_from=ck) == want
    assert m.counters["masked_windows"] == jm.counters["masked_windows"]
    assert m.counters["ambiguous_batches"] == with_n


def test_count_bytes_and_report_keys_equal_the_reference(reads):
    from genome_assembler_tpu.utils.metrics import Metrics as JaxMetrics

    cfg = AssemblyConfig(k=K, read_len=60, batch_reads=150)
    m, jm = Metrics(), JaxMetrics()
    contigs = pipeline.assemble_torch(reads, cfg, device="cpu", metrics=m,
                                      table_capacity=CAP)
    assert contigs == jax_pipeline.assemble_tpu(reads, cfg, metrics=jm,
                                                table_capacity=CAP)
    got, want = m.report(), jm.report()
    # the port's two counters more: the batches in which the card found an
    # N, and the bases of the reverse complements that emission built
    want["counters"]["ambiguous_batches"] = 3
    want["counters"]["revcomp_bases"] = m.counters["revcomp_bases"]
    for part in ("stages_s", "counters", "derived"):
        assert set(got[part]) == set(want[part]), part
    assert m.counters["masked_windows"] == jm.counters["masked_windows"]
    assert m.counters["ambiguous_batches"] == 3
    assert m.counters["revcomp_bases"] > 0
    wc = 60 - K + 1
    # one 8-byte limb a key here, one 4-byte word there
    assert m.counters["count_bytes"] == reads.size + 2 * reads.shape[0] * wc * 8
    assert jm.counters["count_bytes"] == reads.size + 2 * reads.shape[0] * wc * 4
    assert 0 < got["derived"]["count_bytes_per_s"]
    assert "hbm_roofline_frac" in got["derived"]
    # a resumed run counts nothing, in both packages
    m2 = Metrics()
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "t.npz")
        pipeline.assemble_torch(reads, cfg, device="cpu", checkpoint=ck)
        pipeline.assemble_torch(reads, cfg, device="cpu", resume_from=ck,
                                metrics=m2)
    assert "count_bytes" not in m2.counters and "count" not in m2.stages


# ------------------------------------------------- the streamed count, sharded

@pytest.mark.parametrize("d", [2, 4])
def test_sharded_stream_equals_jax_per_shard(monkeypatch, d):
    """Five global batches with a padded tail batch, Ns present."""
    reads = _reads(drop=3)
    cfg = AssemblyConfig(k=K, read_len=60, batch_reads=96)
    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    monkeypatch.setattr(jax_pp, "DIST_STREAM_WINDOWS", 0)
    m = Metrics()
    tables = pp._run_distributed_step(reads, cfg, build_mesh(d, devices=["cpu"]),
                                      table_capacity=CAP, metrics=m)
    mesh = jax_mesh(d)
    words, counts, num = jax_pp._run_distributed_step(
        reads, cfg, mesh, None, mesh_axes(mesh), None, table_capacity=CAP)
    words = np.asarray(words).reshape(d, -1, 1)
    counts = np.asarray(counts).reshape(d, -1)
    for s, t in enumerate(tables):
        n = int(t.num_unique)
        assert n == int(np.asarray(num)[s]) and n > 0 and not bool(t.overflow)
        np.testing.assert_array_equal(
            limbs_to_words(t.limbs[:n].numpy(), K), words[s, :n])
        np.testing.assert_array_equal(t.counts[:n].numpy(), counts[s, :n])
    # the bytes really sent: five padded batches of raw one-byte codes
    assert m.counters["h2d_bytes_reads"] == 5 * 96 * 60
    # two distinct devices: one block a shard, the same tables
    two = pp._run_distributed_step(
        reads, cfg, build_mesh(d, devices=["cpu", "cpu:0"]),
        table_capacity=CAP)
    for a, b in zip(tables, two):
        assert torch.equal(a.limbs, b.limbs) and torch.equal(a.counts, b.counts)


def test_stream_batch_alone_equals_the_streamed_batches():
    reads = _reads(drop=3)
    cfg = AssemblyConfig(k=K, read_len=60, batch_reads=96)
    mesh = build_mesh(4, devices=["cpu"])
    plan = pp._StreamPlan(reads.shape[0], 60, cfg, 4, None, None, CAP)
    streamed = list(pp._stream_batches(mesh, reads, plan, 0))
    assert [b[0] for b in streamed] == list(range(plan.num_batches))
    for i, packed, ext, n_valid in streamed:
        alone = pp._stream_batch(mesh, reads, plan, i)
        assert n_valid == alone[2] and sum(n_valid) == min(
            96, reads.shape[0] - 96 * i)
        # one block on a single-device mesh: every shard has its flag
        has_n = bool((reads[96 * i : 96 * i + 96] > 3).any())
        for s in range(4):
            assert torch.equal(packed[s], alone[0][s])
            for name in ("inv_bits", "flag"):
                assert torch.equal(ext[s][name], alone[1][s][name])
            assert bool(ext[s]["flag"]) == has_n
            rows = reads[96 * i + 24 * s : 96 * i + 24 * s + n_valid[s]]
            if n_valid[s]:
                np.testing.assert_array_equal(
                    packed[s][: n_valid[s]].numpy(), pack_codes(rows))
                np.testing.assert_array_equal(
                    kmer_torch.unpack_invalid_mask(
                        ext[s]["inv_bits"][: n_valid[s]], 60).numpy(),
                    rows > 3)
