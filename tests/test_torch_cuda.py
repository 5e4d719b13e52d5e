"""The port on the card: the extraction kernel against its plain version,
and a small assembly on CUDA against the oracle. These tests need an
NVIDIA GPU and skip without one. The file imports no JAX, so on a machine
without JAX it runs alone:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from genome_assembler_tpu_torch import reference as ref
from genome_assembler_tpu_torch.models.pipeline import assemble_torch
from genome_assembler_tpu_torch.ops import kmer_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda", 0)


# Edge shapes of the kernel's block layout: (reads, read length, k,
# n_valid, share of Ns); reads 1 and 2 of a case are all Ns, and an N in
# the first and in the last base.
EDGE_SHAPES = {
    "one_window_a_read": (5, 31, 31, 5, 0.0),
    "one_two_limb_window": (4, 63, 63, 3, 0.01),
    "k2_len2": (7, 2, 2, 7, 0.1),
    "k2": (3, 100, 2, 3, 0.02),
    "one_read": (1, 100, 31, 1, 0.0),
    "one_read_odd_span": (1, 101, 31, 1, 0.02),
    "ragged_last_block_odd_span": (65, 101, 31, 65, 0.01),
    "n_valid_inside_a_block": (130, 100, 31, 70, 0.01),
    "n_valid_zero": (257, 103, 31, 0, 0.01),
    "k32": (33, 99, 32, 20, 0.02),
    "k63": (33, 97, 63, 33, 0.02),
    "long_reads": (37, 250, 21, 36, 0.01),
    "two_reads_a_block": (3, 4000, 31, 3, 0.001),
    "shared_memory_opt_in": (3, 140_000, 31, 3, 0.0001),
    "mostly_ns": (6, 50, 25, 6, 0.5),
}


@pytest.mark.parametrize("with_bits", [True, False], ids=["bits", "no_bits"])
@pytest.mark.parametrize("case", sorted(EDGE_SHAPES))
def test_kernel_edge_shapes(cuda_device, case, with_bits):
    b, length, k, n_valid, n_rate = EDGE_SHAPES[case]
    rng = np.random.default_rng(b * length + k)
    reads = rng.integers(0, 4, size=(b, length), dtype=np.uint8)
    reads[rng.random(reads.shape) < n_rate] = 4
    if b >= 3:
        reads[1, :] = 4
        reads[2, 0] = reads[2, -1] = 4
    packed = torch.from_numpy(ref.pack_codes(reads)).to(cuda_device)
    inv = ref.pack_invalid_mask(reads)
    if inv is not None and with_bits:
        inv = torch.from_numpy(inv).to(cuda_device)
    else:
        inv = None
    got = kmer_torch.extract_canonical_flat(packed, length, k, n_valid, inv)
    want = kmer_torch.extract_canonical_flat_ref(packed, length, k, n_valid,
                                                 inv)
    torch.cuda.synchronize()
    assert got.is_cuda and torch.equal(got, want)


def test_kernel_refuses_a_shape_it_cannot_take(cuda_device, monkeypatch):
    """Two reads whose packed rows pass a block's shared memory: the
    wrapper raises, and the plain version is never called in its place."""
    def no_plain_version(*args, **kwargs):
        raise AssertionError("the plain version stood in for the kernel")

    monkeypatch.setattr(kmer_torch, "extract_canonical_flat_ref",
                        no_plain_version)
    length = 400_000
    packed = torch.zeros((2, length // 4), dtype=torch.uint8,
                         device=cuda_device)
    before = kmer_torch.extract_canonical_flat.launches
    with pytest.raises(ValueError, match="shared memory"):
        kmer_torch.extract_canonical_flat(packed, length, 31)
    assert kmer_torch.extract_canonical_flat.launches == before


def test_kernel_entry_refuses_a_bad_plan(cuda_device):
    """The C entry checks the plan again: an odd number of reads a block
    (a span off its 16-byte boundary) is an error, not a launch."""
    packed = torch.zeros((4, 25), dtype=torch.uint8, device=cuda_device)
    plan = kmer_torch.launch_plan(100, 31)._replace(reads_per_block=3)
    before = kmer_torch.extract_canonical_flat.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        kmer_torch.launch_kernel(packed, 100, 31, None, None, plan)
    assert kmer_torch.extract_canonical_flat.launches == before


@pytest.mark.parametrize("k", [2, 15, 21, 25, 31, 32, 41, 63])
def test_kernel_matches_plain_version(cuda_device, k):
    rng = np.random.default_rng(k)
    reads = rng.integers(0, 4, size=(333, 100), dtype=np.uint8)
    reads[rng.random(reads.shape) < 0.01] = 4
    packed = torch.from_numpy(ref.pack_codes(reads)).to(cuda_device)
    inv = torch.from_numpy(ref.pack_invalid_mask(reads)).to(cuda_device)
    before = kmer_torch.extract_canonical_flat.launches
    got = kmer_torch.extract_canonical_flat(packed, 100, k, 300, inv)
    assert kmer_torch.extract_canonical_flat.launches == before + 1
    want = kmer_torch.extract_canonical_flat_ref(packed, 100, k, 300, inv)
    torch.cuda.synchronize()
    assert got.is_cuda and torch.equal(got, want)


PACK_CASES = {  # reads, share of Ns, an N in the last base of the last row
    "no_n": (1024, 0.0, False),
    "ns": (1024, 0.01, False),
    "ragged_last_batch": (333, 0.01, False),
    "n_in_last_row_only": (1024, 0.0, True),
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
@pytest.mark.parametrize("length", [99, 100, 101, 250])
def test_pack_kernel_matches_plain_version(cuda_device, length, case):
    """The pack kernel (``csrc/kmer_extract.cu``) against its plain
    version, byte for byte, and its flag and batch count; whole, and from read 1 on (rows off a word
    boundary where L is not a multiple of 4)."""
    b, n_rate, last = PACK_CASES[case]
    rng = np.random.default_rng(length * b)
    reads = rng.integers(0, 4, size=(b, length), dtype=np.uint8)
    reads[rng.random(reads.shape) < n_rate] = 4
    if last:
        reads[-1, -1] = 200
    batches = torch.zeros((), dtype=torch.int64, device=cuda_device)
    for first in (0, 1):
        rows = reads[first:]
        codes = torch.from_numpy(reads).to(cuda_device)[first:]
        before = kmer_torch.pack_on_device.launches
        got = kmer_torch.pack_on_device(codes, batches)
        assert kmer_torch.pack_on_device.launches == before + 1
        want = kmer_torch.pack_on_device(codes.cpu())
        torch.cuda.synchronize()
        assert torch.equal(got.packed.cpu(), want.packed)
        assert torch.equal(got.inv.cpu(), want.inv)
        assert bool(got.flag) == bool(want.flag) == bool((rows > 3).any())
        np.testing.assert_array_equal(got.packed.cpu().numpy(),
                                      ref.pack_codes(rows))
        bits = ref.pack_invalid_mask(rows)
        np.testing.assert_array_equal(
            got.inv.cpu().numpy(),
            np.zeros_like(got.inv.cpu().numpy()) if bits is None else bits)
    assert int(batches) == (2 if (n_rate or last) else 0)


@pytest.mark.parametrize("k", [21, 31, 41])
@pytest.mark.parametrize("n_rate", [0.0, 0.01], ids=["no_n", "ns"])
def test_extraction_reads_the_flag(cuda_device, k, n_rate):
    """Flag at 0: the kernel equals its run without invalid bits (and
    leaves them unread: a zeroed flag over bits with Ns gives the same);
    flag set: the plain version's keys, and the windows the bits mask in
    rows < n_valid counted on the card."""
    from genome_assembler_tpu_torch.ops.kmer_ref import window_valid_np

    rng = np.random.default_rng(k)
    reads = rng.integers(0, 4, size=(1000, 100), dtype=np.uint8)
    reads[rng.random(reads.shape) < n_rate] = 4
    p = kmer_torch.pack_on_device(torch.from_numpy(reads).to(cuda_device))
    masked = torch.zeros((), dtype=torch.int64, device=cuda_device)
    got = kmer_torch.extract_canonical_flat(p.packed, 100, k, 777, p.inv,
                                            flag=p.flag, masked=masked)
    want = kmer_torch.extract_canonical_flat_ref(
        p.packed.cpu(), 100, k, 777, p.inv.cpu())
    no_bits = kmer_torch.extract_canonical_flat(p.packed, 100, k, 777)
    unread = kmer_torch.extract_canonical_flat(
        p.packed, 100, k, 777, p.inv, flag=torch.zeros_like(p.flag),
        masked=masked)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(unread, no_bits)
    if not n_rate:
        assert torch.equal(got, no_bits)
    assert int(masked) == int((~window_valid_np(reads[:777], k)).sum())
    assert (int(masked) > 0) == bool(n_rate)


def test_ambiguous_counters_on_cuda_equal_cpu(cuda_device):
    """A streamed assembly with Ns (12 batches): contigs, masked_windows
    and ambiguous_batches as on the CPU, one pack launch a batch."""
    from genome_assembler_tpu_torch.utils.metrics import Metrics

    reads = _noisy_reads()  # 8000 reads
    reads[700:1400][reads[700:1400] > 3] = 0  # a batch without an N
    cfg = ref.AssemblyConfig(k=31, min_count=3, read_len=100, batch_reads=700)
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        m = Metrics()
        before = kmer_torch.pack_on_device.launches
        contigs = assemble_torch(reads, cfg, device=dev, metrics=m,
                                 table_capacity=1 << 18)
        runs.append((contigs, m.counters["masked_windows"],
                     m.counters["ambiguous_batches"],
                     kmer_torch.pack_on_device.launches - before))
    (gpu, gm, gb, launches), (cpu, cm, cb, _) = runs
    assert gpu == cpu and gm == cm > 0 and gb == cb == 11
    assert launches == 12


def test_assembly_on_cuda_matches_oracle(cuda_device):
    genome = ref.simulate_genome(5000, seed=21)
    rs = ref.simulate_reads(genome, coverage=50, read_len=100, seed=22,
                            error_rate=0.01, tile_k=31)
    cfg = ref.AssemblyConfig(k=31, min_count=3, read_len=100, batch_reads=500)
    got = assemble_torch(rs.codes, cfg, device=cuda_device,
                         table_capacity=1 << 17)
    assert got == ref.assemble_oracle(rs.codes, cfg)


@pytest.mark.parametrize("minimizer", [None, 15], ids=["per_window", "minimizer"])
def test_sharded_count_on_cuda_matches_one_device(cuda_device, minimizer):
    from genome_assembler_tpu_torch.models.pipeline import count_reads_device
    from genome_assembler_tpu_torch.parallel import mesh, pipeline

    genome = ref.simulate_genome(8000, seed=31)
    rs = ref.simulate_reads(genome, coverage=40, read_len=100, seed=32,
                            error_rate=0.01)
    reads = rs.codes.copy()
    reads[np.random.default_rng(33).random(reads.shape) < 0.002] = 4
    cfg = ref.AssemblyConfig(k=31, min_count=3, read_len=100, batch_reads=700)
    m = mesh.build_mesh(4)
    assert m.devices[0].type == "cuda"
    got = pipeline.distributed_count_table(reads, cfg, m, table_capacity=1 << 17,
                                           minimizer_len=minimizer)
    want = count_reads_device(reads, cfg, device=cuda_device,
                              table_capacity=1 << 17)
    n = int(want.num_unique)
    assert int(got.num_unique) == n
    assert torch.equal(got.limbs[:n], want.limbs[:n])
    assert torch.equal(got.counts[:n], want.counts[:n])
    assert pipeline.assemble_distributed(
        reads, cfg, m, minimizer_len=minimizer, table_capacity=1 << 17
    ) == ref.assemble_oracle(reads, cfg)


def test_routing_hash_on_cuda_matches_cpu(cuda_device):
    from genome_assembler_tpu_torch.ops import hash_torch

    x = torch.from_numpy(
        np.random.default_rng(7).integers(0, 1 << 62, size=(4096, 2))
    )
    assert torch.equal(hash_torch.owner_of(x.to(cuda_device), 41, 4).cpu(),
                       hash_torch.owner_of(x, 41, 4))


def test_sharded_graph_on_cuda_matches_cpu(cuda_device):
    """The sharded graph on 4 CUDA shards: every per-shard output and the
    contigs equal the same run's on 4 CPU shards."""
    from genome_assembler_tpu_torch.parallel import compress, mesh, pipeline

    genome = ref.simulate_genome(6000, seed=41)
    rs = ref.simulate_reads(genome, coverage=30, read_len=100, seed=42,
                            error_rate=0.01)
    cfg = ref.AssemblyConfig(k=31, min_count=2, read_len=100)
    runs = []
    for m in (mesh.build_mesh(4), mesh.build_mesh(4, devices=["cpu"])):
        tables = pipeline._shard_filter_compact(
            pipeline._run_distributed_step(rs.codes, cfg, m), cfg.min_count
        )
        g = compress.make_sharded_compress(
            m, cfg.k, tables[0].limbs.shape[0]
        )(tables)
        runs.append((g, pipeline.assemble_distributed_sharded(rs.codes, cfg, m)))
    (gpu, gpu_contigs), (cpu, cpu_contigs) = runs
    assert gpu.valid[0].is_cuda
    for field in ("valid", "uid", "pos", "cov", "last_base", "heads",
                  "edge_limbs"):
        for a, b in zip(getattr(gpu, field), getattr(cpu, field)):
            assert torch.equal(a.cpu(), b), field
    assert (gpu.num_unitigs, gpu.overflow) == (cpu.num_unitigs, cpu.overflow)
    assert gpu_contigs == cpu_contigs == ref.assemble_oracle(rs.codes, cfg)


def test_sampled_ranking_on_cuda_matches_cpu(cuda_device, monkeypatch):
    """The sampled and the cyclic pass on the card: head, rank, ok and the
    broken predecessors equal the CPU's; compress_unitigs_device with the
    sampled bound at 0 equals its exact pass on the card."""
    from genome_assembler_tpu_torch.ops import count_torch, unitig_torch

    rng = np.random.default_rng(5)
    for ncycles in (0, 3):
        order = rng.permutation(20_000)
        prev = np.full(20_000, -1, np.int64)
        for i, part in enumerate(np.array_split(order, 5 + ncycles)):
            prev[part[1:]] = part[:-1]
            if i >= 5:
                prev[part[0]] = part[-1]
        cpu = torch.from_numpy(prev)
        for fn in (unitig_torch._rank_sampled,
                   unitig_torch._rank_sampled_cyclic):
            got, want = fn(cpu.to(cuda_device)), fn(cpu)
            for g, w in zip(got, want):
                assert (g == w) if isinstance(w, bool) else torch.equal(
                    g.cpu(), w)
    genome = ref.simulate_genome(20_000, seed=61)
    rs = ref.simulate_reads(genome, coverage=20, read_len=100, seed=62)
    table = count_torch.count_keys(kmer_torch.extract_canonical_flat(
        torch.from_numpy(ref.pack_codes(rs.codes)).to(cuda_device), 100, 31))
    monkeypatch.setattr(unitig_torch, "SAMPLED_MIN_ROWS", 0)
    rounds = {}
    got = unitig_torch.compress_unitigs_device(table, 31, rounds=rounds)
    want = unitig_torch.compress_unitigs_device(table, 31, _exact=True)
    assert rounds["pass"] == "sampled"
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_bucketed_count_on_cuda_matches_cpu(cuda_device, monkeypatch):
    """The bucketed streaming count on the card, one device and 4 shards:
    the table equals the CPU's flat one."""
    from genome_assembler_tpu_torch.models.pipeline import count_reads_device
    from genome_assembler_tpu_torch.parallel import mesh, pipeline

    reads = _noisy_reads(genome_len=8000, coverage=30)
    cfg = ref.AssemblyConfig(k=31, read_len=100, batch_reads=500)
    want = count_reads_device(reads, cfg, device="cpu", table_capacity=65536,
                              bucketed="off")
    for accum in (1, 4):
        got = count_reads_device(reads, cfg, device=cuda_device,
                                 table_capacity=65536, bucketed="on",
                                 _bucket_accum=accum)
        assert _tables_equal(_to_cpu(got), want)
    monkeypatch.setattr(pipeline, "DIST_STREAM_WINDOWS", 0)
    got = pipeline.distributed_count_table(reads, cfg, mesh.build_mesh(4),
                                           table_capacity=65536, bucketed="on")
    n = int(want.num_unique)
    assert int(got.num_unique) == n
    assert torch.equal(got.limbs[:n].cpu(), want.limbs[:n])
    assert torch.equal(got.counts[:n].cpu(), want.counts[:n])


@pytest.mark.parametrize("layout", ["off", "on"])
def test_strided_count_on_cuda_matches_cpu(cuda_device, monkeypatch, layout):
    """Deferred merges on the card (stride 3, a short last batch, a tail of
    two batches), one device and 4 shards: the table equals the CPU's at
    stride 1."""
    from genome_assembler_tpu_torch.models.pipeline import count_reads_device
    from genome_assembler_tpu_torch.parallel import mesh, pipeline

    reads = _noisy_reads(genome_len=8000, coverage=30)[:2350]
    cfg = ref.AssemblyConfig(k=31, read_len=100, batch_reads=500)
    want = count_reads_device(reads, cfg, device="cpu", table_capacity=65536,
                              bucketed="off")
    got = count_reads_device(reads, cfg, device=cuda_device,
                             table_capacity=65536, bucketed=layout,
                             merge_stride=3)
    assert _tables_equal(_to_cpu(got), want)
    monkeypatch.setattr(pipeline, "DIST_STREAM_WINDOWS", 0)
    got = pipeline.distributed_count_table(
        reads, cfg, mesh.build_mesh(4), table_capacity=65536,
        bucketed=layout, merge_stride=3)
    n = int(want.num_unique)
    assert int(got.num_unique) == n
    assert torch.equal(got.limbs[:n].cpu(), want.limbs[:n])
    assert torch.equal(got.counts[:n].cpu(), want.counts[:n])


def _to_cpu(table):
    return type(table)(*(x.cpu() for x in table))


def _noisy_reads(genome_len=20_000, coverage=40, seed=51, n_rate=0.002):
    genome = ref.simulate_genome(genome_len, seed=seed)
    reads = ref.simulate_reads(genome, coverage=coverage, read_len=100,
                               seed=seed + 1, error_rate=0.01).codes.copy()
    reads[np.random.default_rng(seed).random(reads.shape) < n_rate] = 4
    return reads


def _tables_equal(a, b):
    return (int(a.num_unique) == int(b.num_unique)
            and bool(a.overflow) == bool(b.overflow)
            and torch.equal(a.limbs, b.limbs)
            and torch.equal(a.counts, b.counts))


@pytest.mark.parametrize("batch", [8000, 700, 333],
                         ids=["1_batch", "12_batches", "25_batches"])
def test_upload_ring_equals_plain_upload(cuda_device, batch):
    """Many batches through the pinned ring (a slot is refilled while
    later batches are in flight) against the same batches uploaded one by
    one: the tables are bit-equal, and every batch launched the kernel."""
    from genome_assembler_tpu_torch.models.pipeline import count_reads_device

    reads = _noisy_reads()  # 8000 reads, Ns; 700 and 333 leave a short tail
    cfg = ref.AssemblyConfig(k=31, read_len=100, batch_reads=batch)
    kw = dict(device=cuda_device, table_capacity=1 << 18)
    before = kmer_torch.extract_canonical_flat.launches
    ring = count_reads_device(reads, cfg, **kw)
    assert kmer_torch.extract_canonical_flat.launches - before == -(
        -reads.shape[0] // batch)
    plain = count_reads_device(reads, cfg, _plain_upload=True, **kw)
    cpu = count_reads_device(reads, cfg, device="cpu", table_capacity=1 << 18)
    torch.cuda.synchronize()
    assert ring.limbs.is_cuda and _tables_equal(ring, plain)
    assert _tables_equal(ring._replace(
        limbs=ring.limbs.cpu(), counts=ring.counts.cpu(),
        num_unique=ring.num_unique.cpu(), overflow=ring.overflow.cpu()), cpu)


def test_checkpoint_with_prefetch_in_flight(cuda_device, tmp_path):
    """A snapshot taken while the ring is two batches ahead holds the table
    after its own batch only: the file equals the plain route's, byte for
    byte, and the resumed table the uninterrupted one."""
    from genome_assembler_tpu_torch.models.pipeline import count_reads_device

    reads = _noisy_reads()
    cfg = ref.AssemblyConfig(k=31, read_len=100, batch_reads=700)
    kw = dict(device=cuda_device, table_capacity=1 << 18)
    full = count_reads_device(reads, cfg, **kw)
    files = {}
    for name, plain in (("ring", False), ("plain", True)):
        files[name] = str(tmp_path / f"{name}.npz")
        with pytest.raises(RuntimeError, match="fault injection"):
            count_reads_device(reads, cfg, stream_checkpoint=files[name],
                               stream_checkpoint_every=2, abort_after_batch=5,
                               _plain_upload=plain, **kw)
    with np.load(files["ring"]) as a, np.load(files["plain"]) as b:
        assert sorted(a.files) == sorted(b.files)
        assert int(a["next_start"]) == 4 * 700
        for key in a.files:
            assert np.array_equal(a[key], b[key]), key
    resumed = count_reads_device(reads, cfg, resume_stream_from=files["ring"],
                                 **kw)
    assert _tables_equal(resumed, full)


def test_sharded_stream_ring_equals_cpu_mesh(cuda_device, monkeypatch):
    from genome_assembler_tpu_torch.parallel import mesh, pipeline

    monkeypatch.setattr(pipeline, "DIST_STREAM_WINDOWS", 0)
    reads = _noisy_reads()
    cfg = ref.AssemblyConfig(k=31, read_len=100, batch_reads=1000)
    m = pipeline.Metrics()
    got = pipeline._run_distributed_step(reads, cfg, mesh.build_mesh(4),
                                         table_capacity=1 << 18, metrics=m)
    want = pipeline._run_distributed_step(
        reads, cfg, mesh.build_mesh(4, devices=["cpu"]),
        table_capacity=1 << 18)
    assert m.counters["h2d_bytes_reads"] == 8 * 1000 * 100
    for a, b in zip(got, want):
        assert a.limbs.is_cuda
        assert torch.equal(a.limbs.cpu(), b.limbs)
        assert torch.equal(a.counts.cpu(), b.counts)


def test_trace_holds_cuda_kernels_and_stages(cuda_device, tmp_path):
    from genome_assembler_tpu_torch.utils import metrics

    reads = _noisy_reads()
    cfg = ref.AssemblyConfig(k=31, min_count=3, read_len=100, batch_reads=700)
    assemble_torch(reads, cfg, device=cuda_device, table_capacity=1 << 18)
    m = metrics.Metrics()
    with metrics.profiler_trace(str(tmp_path)):
        assemble_torch(reads, cfg, device=cuda_device, metrics=m,
                       table_capacity=1 << 18)
    trace = metrics.read_trace(str(tmp_path))
    assert {"count", "filter", "compress", "spell", "simplify",
            "traverse"} <= set(trace.stages)
    names = trace.kernel_names()
    assert any("extract_canonical" in n for n in names), sorted(names)[:20]
    assert any("memcpy" in n.lower() for n in names)
    busy, wall = trace.busy_share("count")
    assert 0 < busy <= wall
    derived = m.report()["derived"]
    assert derived["count_bytes_per_s"] > 0
    assert 0 <= derived["hbm_roofline_frac"] < 1  # rounded to 3 places


def test_host_spans_share_the_device_clock(cuda_device, tmp_path):
    """One streamed assembly (12 batches through the ring) traced: the
    device work launched inside ``count`` ends by the end of its closing
    synchronise (``count.sync``, 50 us of slack), and the ring waits for
    each reused slot and once as it closes (``count.wait``)."""
    from genome_assembler_tpu_torch.models.pipeline import UPLOAD_PREFETCH
    from genome_assembler_tpu_torch.utils import metrics

    reads = _noisy_reads()  # 8000 reads
    batches = 12
    cfg = ref.AssemblyConfig(k=31, min_count=3, read_len=100, batch_reads=700)
    assemble_torch(reads, cfg, device=cuda_device, table_capacity=1 << 18)
    m = metrics.Metrics()
    with metrics.profiler_trace(str(tmp_path)):
        assemble_torch(reads, cfg, device=cuda_device, metrics=m,
                       table_capacity=1 << 18)
    trace = metrics.read_trace(str(tmp_path))
    [(lo, hi)], [(s0, s1)] = trace.stages["count"], trace.stages["count.sync"]
    assert lo <= s0 and s1 <= hi
    ends = [end for start, end, _ in trace.device if lo <= start < hi]
    assert ends and max(ends) <= s1 + 50
    assert len(trace.stages["count.fill"]) == batches
    assert len(trace.stages["count.step"]) == batches
    waits = batches - (UPLOAD_PREFETCH + 1) + 1
    assert len(trace.stages["count.wait"]) == m.spans["count.wait"][1] == waits


@pytest.mark.parametrize("world", [1, 2, 4])
def test_nccl_ranks_equal_single_process_mesh(tmp_path, world):
    """The multi-process mesh over NCCL, a card a rank (4 shards over
    ``world`` ranks): every collective alone, the per-rank count tables, the
    sharded compression and both kinds of checkpoint against the
    single-process mesh on the same card, bit for bit. The ranks are
    ``tests/test_torch_mesh.py`` run as a script (it imports no JAX
    either); one rank needs one card, more ranks as many cards."""
    import json
    import os

    from genome_assembler_tpu_torch.parallel.launch import spawn

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} cards, {torch.cuda.device_count()} visible")
    out = str(tmp_path / "r")
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "test_torch_mesh.py")
    res = spawn(world, ["--job", "checks", "--out", out], device="cuda",
                timeout_s=600.0, entry=(worker,))
    assert res.ok, res.describe()
    for r in range(world):
        with open(f"{out}.rank{r}.json") as fh:
            verdicts = json.load(fh)
        assert verdicts and all(v is None for v in verdicts.values()), {
            k: v for k, v in verdicts.items() if v is not None}


def _load_script(*parts):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), *parts)
    spec = importlib.util.spec_from_file_location(parts[-1][:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_torch_on_the_card(cuda_device):
    """``bench_torch.py`` at 100 kb, 10x, one rep: the kernel equal to its
    plain version at the bench's shape, the streamed table equal to the
    single shot, the contig equal to the genome, the roofline share below
    one, and the kernel's launches by leg."""
    bench = _load_script("bench_torch.py")
    line = bench.run(bench.parse_args([
        "--genome-len", "100000", "--coverage", "10", "--reps", "1",
        "--baseline-windows", "2000"]))
    d = line["detail"]
    assert d["backend"] == "cuda" and d["card"] and d["build_s"] is not None
    assert d["extract_equal"] is True and d["stream_table_equal"] is True
    assert d["exact_match"] is True and d["contigs"] == 1
    assert 0 < d["min_traffic_roofline_frac"] < 1
    assert d["extract_kernel_s"] > 0 and d["extract_bound_s"] > 0
    # count: warm-up + 1 rep; extraction: the check, a warm-up, 20 timed;
    # stream: 2 two-batch streamed counts and 2 single shots; assemble:
    # cold and warm, one shot each
    assert d["extract_launches"] == {
        "count": 2, "extraction": 22, "stream": 6, "assemble": 2}
    # packed on the card: the streamed counts' 4 batches and the
    # assemblies' 2 (the count and single-shot legs pack on the host)
    assert d["pack_launches"] == {
        "count": 0, "extraction": 0, "stream": 4, "assemble": 2}
    # inserted on the card: the streamed counts' 4 batches (the
    # assemblies count in one shot)
    assert d["insert_launches"] == {
        "count": 0, "extraction": 0, "stream": 4, "assemble": 0}


def test_run_large_torch_on_the_card(cuda_device):
    """``tools/run_large_torch.py`` at 0.2 Mb, 25x: one contig equal to
    the genome, the k-mer content check on the card equal to the CPU's,
    the peak memory and the launches of the cold and warm runs."""
    tool = _load_script("tools", "run_large_torch.py")
    line = tool.run(tool.parse_args(["0.2", "25", "31"]))
    assert line["contigs"] == 1 and line["n50"] == 200_000
    assert line["exact_single_contig"] is True
    assert line["exact_kmer_content"] is True
    assert line["peak_gib"] > 0 and line["extract_launches"] == 2
    assert line["pack_launches"] == 2 and line["insert_launches"] == 2
    seq = ref.decode_seq(ref.simulate_genome(30_000, seed=9))
    for k in (31, 41):
        assert torch.equal(tool.canonical_keys(seq, k, cuda_device).cpu(),
                           tool.canonical_keys(seq, k, torch.device("cpu")))


# ---- the streamed count's hash table (count_insert_kernel) ----


def _key_batches(case):
    """Batches of [N, 1] int64 keys on the CPU, one case each."""
    from genome_assembler_tpu_torch.ops.hash_torch import owner_of
    from genome_assembler_tpu_torch.utils.keys import SENTINEL

    rng = np.random.default_rng(17)

    def col(values):
        return torch.tensor(values, dtype=torch.int64)[:, None]

    if case == "repeats":  # 8 batches drawn from 30,000 keys
        pool = rng.integers(0, 1 << 62, 30_000)
        return [col(rng.choice(pool, 50_000)) for _ in range(8)]
    if case == "one_key":
        return [col([987654321] * 200_000)] * 3
    if case == "sentinel_padded":  # routed buffers: lanes left empty
        out = []
        for _ in range(4):
            keys = rng.integers(0, 1 << 40, 60_000)
            keys[rng.random(60_000) < 0.5] = SENTINEL
            out.append(col(keys))
        return out
    if case == "one_owner_shard":  # every key of shard 0 of 4
        keys = col(rng.integers(0, 1 << 62, 200_000))
        keys = keys[owner_of(keys, 31, 4) == 0][:20_000]
        return [keys[rng.integers(0, keys.shape[0], 40_000)]
                for _ in range(5)]
    raise ValueError(case)


def _sort_merged(batches, capacity):
    from genome_assembler_tpu_torch.ops.stream_table import CarriedTable

    carried = CarriedTable(capacity, 1, torch.device("cpu"), None)
    for keys in batches:
        carried.add(keys)
    return carried.finish()


@pytest.mark.parametrize("case", ["repeats", "one_key", "sentinel_padded",
                                  "one_owner_shard"])
def test_count_insert_kernel_equals_the_flat_merge(cuda_device, case):
    """The kernel's table, sorted, equals the CPU's flat sort merges bit
    for bit; the claimed slots are the occupied ones; every batch is one
    launch."""
    from genome_assembler_tpu_torch.ops import count_hash_torch as ch
    from genome_assembler_tpu_torch.utils.keys import SENTINEL

    batches = _key_batches(case)
    ht = ch.empty_hash(65_536, cuda_device)
    before = ch.count_insert.launches
    for keys in batches:
        ch.count_insert(ht, keys.to(cuda_device))
    got = _to_cpu(ch.hash_to_table(ht))
    assert ch.count_insert.launches - before == len(batches)
    assert _tables_equal(got, _sort_merged(batches, 65_536))
    assert int(ht.claimed) == int((ht.slots[:, 0] != SENTINEL).sum())


def test_count_insert_kernel_takes_weights(cuda_device):
    """A table's rows with their counts (a resumed checkpoint), then more
    batches: the table of the sort merges."""
    from genome_assembler_tpu_torch.ops import count_hash_torch as ch

    batches = _key_batches("repeats")
    first = _sort_merged(batches[:4], 65_536)
    ht = ch.empty_hash(65_536, cuda_device)
    ch.count_insert(ht, first.limbs.to(cuda_device),
                    first.counts.to(cuda_device))
    for keys in batches[4:]:
        ch.count_insert(ht, keys.to(cuda_device))
    assert _tables_equal(_to_cpu(ch.hash_to_table(ht)),
                         _sort_merged(batches, 65_536))


@pytest.mark.parametrize("capacity", [40_000, 30_000, 20_000, 15_500, 7_000],
                         ids=["within", "at", "1.5x", "1.94x", "past_slots"])
def test_count_insert_kernel_overflow(cuda_device, capacity):
    """30,000 unique keys: flagged exactly when they pass the capacity;
    up to twice the capacity the table is the flat merge's (the smallest
    keys with their full counts); past the slots only the flag holds."""
    from genome_assembler_tpu_torch.ops import count_hash_torch as ch

    batches = _key_batches("repeats")
    unique = torch.unique(torch.cat(batches)).numel()
    assert 29_000 < unique <= 30_000
    ht = ch.empty_hash(capacity, cuda_device)
    for keys in batches:
        ch.count_insert(ht, keys.to(cuda_device))
    got = _to_cpu(ch.hash_to_table(ht))
    assert bool(got.overflow) == (unique > capacity)
    if unique <= 2 * capacity:
        assert _tables_equal(got, _sort_merged(batches, capacity))
    else:
        assert int(ht.claimed) == ht.slots.shape[0]


def test_count_insert_kernel_refuses_a_bad_table(cuda_device):
    from genome_assembler_tpu_torch.ops import _build
    from genome_assembler_tpu_torch.ops import count_hash_torch as ch

    ht = ch.empty_hash(64, cuda_device)
    keys = torch.zeros((8, 1), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ch.count_insert(ht, keys.new_zeros((8, 2))[:, :1])
    with pytest.raises(ValueError, match="table on"):
        ch.count_insert(ht, keys.cpu())
    fn = _build.count_insert_fn()
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    args = (keys.data_ptr(), None, 8, ht.slots.data_ptr())
    rest = (ht.claimed.data_ptr(), ht.overflow.data_ptr(), stream)
    assert fn(*args, 100, 64, *rest) != 0  # slots not a power of two
    assert fn(*args, 128, 129, *rest) != 0  # capacity past the slots
    assert fn(keys.data_ptr(), None, 8, ht.slots.data_ptr() + 8, 64, 32,
              *rest) != 0  # a table off 16 bytes
    assert fn(*args, 128, 64, *rest) == 0
    torch.cuda.synchronize(cuda_device)


def _layout_kw(layout, monkeypatch):
    from genome_assembler_tpu_torch.ops import stream_table

    if layout == "auto":  # the bound passed: auto takes the buckets
        monkeypatch.setattr(stream_table, "BUCKETED_MIN_MERGE_ROWS", 0)
        return {"bucketed": "auto"}
    if layout == "on":
        return {"bucketed": "on", "_buckets": 8, "_bucket_accum": 3}
    return {"bucketed": "off"}


@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("layout", ["off", "auto", "on"])
def test_hash_count_on_cuda_equals_cpu_sort_merges(cuda_device, monkeypatch,
                                                   layout, stride):
    """The streamed count on the card (the hash table) against the CPU's
    sort merges, flat, auto-bucketed and bucketed, strides 1 and 3, one
    device and 4 shards: the tables equal bit for bit, and every batch went
    through the insert kernel (``hash_batches``)."""
    from genome_assembler_tpu_torch.models.pipeline import count_reads_device
    from genome_assembler_tpu_torch.ops import count_hash_torch as ch
    from genome_assembler_tpu_torch.parallel import mesh, pipeline
    from genome_assembler_tpu_torch.utils.metrics import Metrics

    reads = _noisy_reads(genome_len=8000, coverage=30)[:2350]  # 5 batches
    cfg = ref.AssemblyConfig(k=31, read_len=100, batch_reads=500)
    kw = dict(table_capacity=65536, merge_stride=stride,
              **_layout_kw(layout, monkeypatch))
    want = count_reads_device(reads, cfg, device="cpu", **kw)
    m = Metrics()
    got = count_reads_device(reads, cfg, device=cuda_device, metrics=m, **kw)
    assert _tables_equal(_to_cpu(got), want)
    assert m.counters["hash_batches"] == 5
    assert m.counters["hash_slots"] == ch.hash_slots(65536)
    monkeypatch.setattr(pipeline, "DIST_STREAM_WINDOWS", 0)
    m = Metrics()
    got = pipeline._run_distributed_step(reads, cfg, mesh.build_mesh(4),
                                         metrics=m, **kw)
    cpu = pipeline._run_distributed_step(
        reads, cfg, mesh.build_mesh(4, devices=["cpu"]), **kw)
    assert m.counters["hash_batches"] == 5
    for a, b in zip(got, cpu):
        assert a.limbs.is_cuda and _tables_equal(_to_cpu(a), b)


@pytest.mark.parametrize("layout", ["off", "on"])
def test_hash_checkpoints_on_cuda_cross_cpu_sort_merges(cuda_device,
                                                        monkeypatch, tmp_path,
                                                        layout):
    """A mid-stream checkpoint of the card's hash path is the CPU sort
    merges' file at the same cursor; each resumes the other's to the full
    table; one device and 4 shards."""
    from genome_assembler_tpu_torch.models.pipeline import count_reads_device
    from genome_assembler_tpu_torch.parallel import mesh, pipeline

    reads = _noisy_reads(genome_len=8000, coverage=30)  # 10 batches
    cfg = ref.AssemblyConfig(k=31, read_len=100, batch_reads=240)
    kw = dict(table_capacity=65536, **_layout_kw(layout, monkeypatch))
    files = {}
    for dev in ("cpu", cuda_device):
        files[dev] = str(tmp_path / f"{torch.device(dev).type}.npz")
        with pytest.raises(RuntimeError, match="fault injection"):
            count_reads_device(reads, cfg, device=dev,
                               stream_checkpoint=files[dev],
                               stream_checkpoint_every=2,
                               abort_after_batch=5, **kw)
    _files_equal(files["cpu"], files[cuda_device])
    full = count_reads_device(reads, cfg, device="cpu", **kw)
    assert _tables_equal(_to_cpu(count_reads_device(
        reads, cfg, device=cuda_device, resume_stream_from=files["cpu"],
        **kw)), full)
    assert _tables_equal(count_reads_device(
        reads, cfg, device="cpu", resume_stream_from=files[cuda_device],
        **kw), full)

    monkeypatch.setattr(pipeline, "DIST_STREAM_WINDOWS", 0)
    meshes = {"cpu": mesh.build_mesh(4, devices=["cpu"]),
              "cuda": mesh.build_mesh(4)}
    shard = {}
    for name, msh in meshes.items():
        shard[name] = str(tmp_path / f"shards_{name}.npz")
        with pytest.raises(RuntimeError, match="fault injection"):
            pipeline._run_distributed_step(
                reads, cfg, msh, stream_checkpoint=shard[name],
                stream_checkpoint_every=2, abort_after_batch=5, **kw)
    _files_equal(shard["cpu"], shard["cuda"])
    want = pipeline._run_distributed_step(reads, cfg, meshes["cpu"], **kw)
    for name, other in (("cuda", "cpu"), ("cpu", "cuda")):
        got = pipeline._run_distributed_step(
            reads, cfg, meshes[name], resume_stream_from=shard[other], **kw)
        for a, b in zip(got, want):
            assert _tables_equal(_to_cpu(a), b)


def _files_equal(path_a, path_b):
    with np.load(path_a) as a, np.load(path_b) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name])


def test_a_full_bucket_flags_no_overflow_on_the_card(cuda_device,
                                                     monkeypatch):
    """Buckets of a quarter of their expected rows: the CPU's bucketed
    sort merges flag overflow; the card's hash table, whose unique keys
    stay within the capacity, gives the exact flat table (ROADMAP F)."""
    from genome_assembler_tpu_torch.models.pipeline import count_reads_device
    from genome_assembler_tpu_torch.ops import stream_table

    reads = _noisy_reads(genome_len=8000, coverage=30)
    cfg = ref.AssemblyConfig(k=31, read_len=100, batch_reads=500)
    flat = count_reads_device(reads, cfg, device="cpu",
                              table_capacity=65536, bucketed="off")
    cap = 2 * int(flat.num_unique)
    monkeypatch.setattr(stream_table, "BUCKET_CB_SLACK", 0.25)
    kw = dict(table_capacity=cap, bucketed="on", _buckets=8)
    assert bool(count_reads_device(reads, cfg, device="cpu", **kw).overflow)
    got = _to_cpu(count_reads_device(reads, cfg, device=cuda_device, **kw))
    want = count_reads_device(reads, cfg, device="cpu", table_capacity=cap,
                              bucketed="off")
    assert not bool(got.overflow) and _tables_equal(got, want)


def test_a_bucketed_checkpoint_that_drops_keys_is_refused_on_the_card(
        cuda_device, monkeypatch, tmp_path):
    """The same buckets with a checkpoint: the card's bucketed snapshot
    would drop keys of its exact table, so the checkpoint is refused and
    no file is written; a flat checkpoint of the same run resumes to the
    uninterrupted table."""
    from genome_assembler_tpu_torch.models.pipeline import count_reads_device
    from genome_assembler_tpu_torch.ops import stream_table

    reads = _noisy_reads(genome_len=8000, coverage=30)
    cfg = ref.AssemblyConfig(k=31, read_len=100, batch_reads=500)
    cap = 2 * int(count_reads_device(reads, cfg, device="cpu",
                                     table_capacity=65536,
                                     bucketed="off").num_unique)
    monkeypatch.setattr(stream_table, "BUCKET_CB_SLACK", 0.25)
    ck = str(tmp_path / "mid.npz")
    # the snapshot after batch 4 of 5, when some bucket is past its rows
    stop = dict(stream_checkpoint=ck, stream_checkpoint_every=4,
                abort_after_batch=4)
    with pytest.raises(RuntimeError, match="bucketed checkpoint cannot hold"):
        count_reads_device(reads, cfg, device=cuda_device, table_capacity=cap,
                           bucketed="on", _buckets=8, _bucket_accum=1,
                           **stop)
    assert not (tmp_path / "mid.npz").exists()
    off = dict(device=cuda_device, table_capacity=cap, bucketed="off")
    with pytest.raises(RuntimeError, match="fault injection"):
        count_reads_device(reads, cfg, **off, **stop)
    got = _to_cpu(count_reads_device(reads, cfg, resume_stream_from=ck, **off))
    want = count_reads_device(reads, cfg, device="cpu", table_capacity=cap,
                              bucketed="off")
    assert _tables_equal(got, want)


def test_two_limb_keys_on_cuda_keep_the_sort_merges(cuda_device):
    """k = 41 on the card merges by sorts (no hash table): the table equals
    the CPU's, and no batch went through the insert kernel."""
    from genome_assembler_tpu_torch.models.pipeline import count_reads_device
    from genome_assembler_tpu_torch.utils.metrics import Metrics

    reads = _noisy_reads(genome_len=8000, coverage=30)[:2350]
    cfg = ref.AssemblyConfig(k=41, read_len=100, batch_reads=500)
    m = Metrics()
    got = count_reads_device(reads, cfg, device=cuda_device, metrics=m,
                             table_capacity=65536)
    want = count_reads_device(reads, cfg, device="cpu", table_capacity=65536)
    assert _tables_equal(_to_cpu(got), want)
    assert "hash_batches" not in m.counters
