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
