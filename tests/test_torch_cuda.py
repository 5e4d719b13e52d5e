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
