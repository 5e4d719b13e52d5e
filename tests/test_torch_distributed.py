"""The port's sharded counter (``parallel/``) against the JAX package on its
8-device CPU mesh and the host oracle: per-shard tables, gathered tables
and contigs, all compared for exact equality. The port's meshes place
their shards on the CPU (``build_mesh(d, devices=["cpu"])``)."""

import json

import numpy as np
import pytest
import torch

import genome_assembler_tpu.parallel.pipeline as jax_pp
import genome_assembler_tpu_torch.parallel.pipeline as pp
from genome_assembler_tpu.models.oracle import assemble_oracle, count_canonical_fast
from genome_assembler_tpu.parallel.compress import _bucket_pack as jax_bucket_pack
from genome_assembler_tpu.parallel.mesh import build_mesh as jax_mesh
from genome_assembler_tpu.parallel.mesh import mesh_axes
from genome_assembler_tpu.utils.config import AssemblyConfig
from genome_assembler_tpu.utils.dna import decode_seq
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads
from genome_assembler_tpu_torch import cli
from genome_assembler_tpu_torch.models import pipeline
from genome_assembler_tpu_torch.parallel import mesh as mesh_mod
from genome_assembler_tpu_torch.utils.keys import SENTINEL, limbs_to_words
from genome_assembler_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(1)

K = 21
CFG = AssemblyConfig(k=K, read_len=60, batch_reads=64)


def cpu_mesh(d):
    return mesh_mod.build_mesh(d, devices=["cpu"])


def _reads(genome_len=1500, coverage=15, read_len=60, seed=5, n_rate=0.0,
           drop=0):
    genome = simulate_genome(genome_len, seed=seed)
    codes = simulate_reads(genome, coverage=coverage, read_len=read_len,
                           seed=seed + 1).codes.copy()
    if n_rate:
        rng = np.random.default_rng(seed + 2)
        codes[rng.random(codes.shape) < n_rate] = 4
    return codes[: codes.shape[0] - drop]


@pytest.fixture(scope="module")
def reads():
    """Ns, and a read count that no shard count or batch divides."""
    return _reads(n_rate=0.003, drop=3)


@pytest.fixture(scope="module")
def jax_shard_tables(reads):
    """The JAX package's per-shard tables, one-shot and streamed, for
    D in {2, 4}: {(d, streamed): (words [D, C, W], counts [D, C], num)}."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for streamed in (False, True):
            if streamed:
                mp.setattr(jax_pp, "DIST_STREAM_WINDOWS", 0)
            for d in (2, 4):
                mesh = jax_mesh(d)
                words, counts, num = jax_pp._run_distributed_step(
                    reads, CFG, mesh, None, mesh_axes(mesh), None,
                    table_capacity=4096,
                )
                out[d, streamed] = (
                    np.asarray(words).reshape(d, -1, 2),
                    np.asarray(counts).reshape(d, -1),
                    np.asarray(num),
                )
    return out


@pytest.mark.parametrize("streamed", [False, True], ids=["one_shot", "streamed"])
@pytest.mark.parametrize("d", [2, 4])
def test_shard_tables_equal_jax(reads, jax_shard_tables, monkeypatch, d,
                                streamed):
    if streamed:
        monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    tables = pp._run_distributed_step(reads, CFG, cpu_mesh(d),
                                      table_capacity=4096)
    words, counts, num = jax_shard_tables[d, streamed]
    assert len(tables) == d
    for s, t in enumerate(tables):
        n = int(t.num_unique)
        assert n == int(num[s]) and n > 0 and not bool(t.overflow)
        np.testing.assert_array_equal(
            limbs_to_words(t.limbs[:n].numpy(), K), words[s, :n]
        )
        np.testing.assert_array_equal(t.counts[:n].numpy(), counts[s, :n])


@pytest.fixture(scope="module")
def single_device_table(reads):
    return pipeline.count_reads_device(reads, CFG, device="cpu")


@pytest.mark.parametrize("minimizer", [None, 11], ids=["per_window", "minimizer"])
@pytest.mark.parametrize("streamed", [False, True], ids=["one_shot", "streamed"])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_gathered_table_equals_single_device_and_oracle(
    reads, single_device_table, monkeypatch, d, streamed, minimizer
):
    if streamed:
        monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    table = pp.distributed_count_table(
        reads, CFG, cpu_mesh(d), minimizer_len=minimizer, table_capacity=4096
    )
    want = single_device_table
    n = int(want.num_unique)
    assert int(table.num_unique) == n and not bool(table.overflow)
    assert torch.equal(table.limbs[:n], want.limbs[:n])
    assert torch.equal(table.counts[:n], want.counts[:n])
    assert pipeline.table_to_host_counts(table, K) == count_canonical_fast(
        reads, K
    )


@pytest.mark.parametrize("stride", [1, 2], ids=["per_batch", "stride_2"])
@pytest.mark.parametrize("streamed", [False, True], ids=["one_shot", "streamed"])
def test_host_counts_equal_jax_distributed_count_to_host(
        reads, monkeypatch, streamed, stride):
    """The JAX package's ``distributed_count_to_host`` has no port (nothing
    calls it): ``table_to_host_counts(distributed_count_table(...))`` is
    the same dict."""
    if streamed:
        monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
        monkeypatch.setattr(jax_pp, "DIST_STREAM_WINDOWS", 0)
    kw = dict(table_capacity=4096, merge_stride=stride)
    want = jax_pp.distributed_count_to_host(reads, CFG, jax_mesh(4), **kw)
    table = pp.distributed_count_table(reads, CFG, cpu_mesh(4), **kw)
    assert pipeline.table_to_host_counts(table, K) == want


@pytest.mark.parametrize("minimizer", [None, 11], ids=["per_window", "minimizer"])
def test_mesh_over_two_devices(reads, single_device_table, monkeypatch,
                               minimizer):
    """Shards on distinct devices take the per-pair copy path of the
    collectives (``cpu`` and ``cpu:0`` are two devices to the mesh)."""
    monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    mesh = mesh_mod.build_mesh(4, devices=["cpu", "cpu:0"])
    assert not mesh.single_device
    table = pp.distributed_count_table(reads, CFG, mesh, table_capacity=4096,
                                       minimizer_len=minimizer)
    n = int(single_device_table.num_unique)
    assert int(table.num_unique) == n
    assert torch.equal(table.limbs[:n], single_device_table.limbs[:n])
    assert torch.equal(table.counts[:n], single_device_table.counts[:n])


@pytest.fixture(scope="module")
def assembly_reads():
    genome = simulate_genome(2500, seed=51)
    return simulate_reads(genome, coverage=20, read_len=100, seed=52,
                          error_rate=0.005).codes


@pytest.fixture(scope="module")
def jax_contigs(assembly_reads):
    mesh = jax_mesh(4)
    return {
        k: jax_pp.assemble_distributed(
            assembly_reads, AssemblyConfig(k=k, min_count=0, read_len=100),
            mesh,
        )
        for k in (31, 24)
    }


@pytest.mark.parametrize("minimizer", [None, 15], ids=["per_window", "minimizer"])
@pytest.mark.parametrize("k", [31, 24], ids=["odd_k", "even_k"])
def test_assemble_distributed_equals_jax_and_oracle(
    assembly_reads, jax_contigs, k, minimizer
):
    if minimizer and k % 2 == 0:
        minimizer = 11
    cfg = AssemblyConfig(k=k, min_count=0, read_len=100)
    m = Metrics()
    got = pp.assemble_distributed(assembly_reads, cfg, cpu_mesh(4),
                                  metrics=m, minimizer_len=minimizer)
    assert got == jax_contigs[k]
    assert got == assemble_oracle(assembly_reads, cfg)
    assert got
    assert m.counters["shards"] == 4 and m.counters["hosts"] == 1
    assert m.counters["a2a_bytes_count"] > 0
    assert m.counters["h2d_bytes_reads"] > 0
    assert m.counters["gather_bytes_table"] > 0
    assert "count" in m.stages and "traverse" in m.stages


@pytest.mark.parametrize("streamed", [False, True], ids=["one_shot", "streamed"])
def test_bucket_overflow_raises(reads, monkeypatch, streamed):
    if streamed:
        monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
    with pytest.raises(RuntimeError, match="overflow"):
        pp.distributed_count_table(reads, CFG, cpu_mesh(2), bucket_cap=1,
                                   table_capacity=4096)


def test_wire_bytes_recorded():
    codes = _reads(genome_len=3000, read_len=100, coverage=15)
    cfg = AssemblyConfig(k=31, read_len=100)
    one, plain, mini = Metrics(), Metrics(), Metrics()
    want = count_canonical_fast(codes, 31)

    def counted(d, m, **kw):
        table = pp.distributed_count_table(codes, cfg, cpu_mesh(d), metrics=m,
                                           **kw)
        return pipeline.table_to_host_counts(table, 31)

    assert counted(1, one) == want
    assert one.counters["a2a_bytes_count"] == 0
    assert one.counters["gather_bytes_table"] > 0
    assert counted(4, plain) == want
    assert counted(4, mini, minimizer_len=15) == want
    assert 0 < mini.counters["a2a_bytes_count"] < (
        plain.counters["a2a_bytes_count"] / 2
    )


def test_bucket_pack_equals_jax_per_bucket():
    rng = np.random.default_rng(3)
    n, d, cap = 500, 4, 150
    vals = rng.integers(0, 1 << 30, size=(n, 3)).astype(np.int32)
    owner = rng.integers(0, d, size=n).astype(np.int32)
    valid = rng.random(n) < 0.9
    for c in (cap, 100):  # 100: some owner overflows its bucket
        send, ovf = pp.bucket_pack(torch.from_numpy(vals),
                                   torch.from_numpy(owner).long(),
                                   torch.from_numpy(valid), d, c, -1)
        r_send, r_ovf = jax_bucket_pack(vals, owner, valid, d, c)
        r_send = np.asarray(r_send)
        assert bool(ovf) == bool(r_ovf) == (c == 100)
        for j in range(d):
            if c == cap:  # no bucket truncated: the same rows per bucket
                np.testing.assert_array_equal(
                    np.sort(send[j].numpy(), axis=0), np.sort(r_send[j], axis=0)
                )
            held = send[j][send[j][:, 0] != -1]
            assert held.shape[0] == min(c, int((valid & (owner == j)).sum()))
    keys = torch.tensor([[5], [SENTINEL], [7]])
    send, _ = pp.bucket_pack(keys, torch.tensor([1, 0, 1]),
                             torch.tensor([True, False, True]), 2, 3, SENTINEL)
    assert send[0].eq(SENTINEL).all() and sorted(send[1, :2, 0].tolist()) == [5, 7]


def test_build_mesh_placement_and_errors():
    mesh = mesh_mod.build_mesh(4, devices=["cpu"])
    assert mesh.size == 4 and mesh.single_device
    assert mesh_mod.num_hosts(mesh) == 1
    with pytest.raises(ValueError, match="multiple"):
        mesh_mod.build_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="multiple"):
        mesh_mod.build_mesh(0, devices=["cpu"])
    # collectives: recv[j] = concat over i of send[i][j]
    send = [torch.arange(8).reshape(2, 2, 2) + 10 * i for i in range(2)]
    recv = mesh_mod.all_to_all(mesh_mod.build_mesh(2, devices=["cpu"]), send)
    assert torch.equal(recv[0], torch.cat([send[0][0], send[1][0]]))
    assert torch.equal(recv[1], torch.cat([send[0][1], send[1][1]]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no fallback"):
            mesh_mod.build_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh_mod.build_mesh(4, devices=["cuda"])


def test_cli_dist_backend(tmp_path, assembly_reads):
    reads_file = tmp_path / "reads.txt"
    reads_file.write_text(
        "\n".join(decode_seq(r) for r in assembly_reads[:300]) + "\n"
    )
    out, metrics = str(tmp_path / "c.fa"), str(tmp_path / "m.json")
    base = ["assemble", "--reads", str(reads_file), "-k", "25",
            "--backend", "dist", "--devices", "4"]
    assert cli.main(base + ["--device", "cpu", "--out", out,
                            "--metrics-out", metrics]) == 0
    from genome_assembler_tpu.cli import read_sequences

    want = assemble_oracle(assembly_reads[:300],
                           AssemblyConfig(k=25, read_len=100))
    assert read_sequences(out) == want
    report = json.loads(open(metrics).read())
    assert report["shards"] == 4 and report["shard_devices"] == ["cpu"] * 4
    assert report["counters"]["a2a_bytes_count"] > 0
    if not torch.cuda.is_available():
        out2 = tmp_path / "c2.fa"
        assert cli.main(base + ["--device", "cuda", "--out", str(out2)]) == 2
        assert not out2.exists()
