"""The port's sharded graph (``parallel/compress.py``,
``assemble_distributed_sharded``) against the JAX package on its 8-device
CPU mesh and the host oracle.

Both packages get the same per-shard filtered tables (the JAX package's
``_run_distributed_step`` + ``_shard_filter_compact``, fitted to one
shard capacity so that one JAX compile serves every workload at a D).
Every per-shard output of the sharded compression must be exactly equal
at the same D; both packages rank with the sampled two-level pass there
(and the exact pass where it refuses, on the circular workload). The
spelled UnitigArrays and the contigs must be equal too. The port's meshes place their shards on the CPU.
"""

import json

import numpy as np
import pytest
import torch

import genome_assembler_tpu.parallel.compress as jax_compress
import genome_assembler_tpu.parallel.pipeline as jax_pp
import genome_assembler_tpu_torch.parallel.compress as compress
import genome_assembler_tpu_torch.parallel.pipeline as pp
from genome_assembler_tpu.cli import read_sequences
from genome_assembler_tpu.models.oracle import assemble_oracle
from genome_assembler_tpu.parallel.mesh import build_mesh as jax_mesh
from genome_assembler_tpu.parallel.mesh import mesh_axes
from genome_assembler_tpu.utils.config import AssemblyConfig
from genome_assembler_tpu.utils.dna import decode_seq, encode_seq
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads
from genome_assembler_tpu_torch import cli
from genome_assembler_tpu_torch.ops import count_torch
from genome_assembler_tpu_torch.parallel import mesh as mesh_mod
from genome_assembler_tpu_torch.utils.keys import limbs_to_words
from genome_assembler_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(1)

# one shard capacity for every workload (each keeps < 2,000 k-mers a
# shard), so k_cap = 8192 is a multiple of the sampled stride: the JAX
# package takes its sampled ranking, and falls back to exact on a cycle
C_SHARD = 4096
WORKLOADS = ["linear", "errors", "repeat", "circular"]


def cpu_mesh(d):
    return mesh_mod.build_mesh(d, devices=["cpu"])


def _tiled(seq, read_len):
    return np.stack([encode_seq(seq[i : i + read_len])
                     for i in range(len(seq) - read_len + 1)])


def _workload(name):
    """(reads, cfg) of the reference's sharded-graph test workloads."""
    if name in ("linear", "errors"):
        # errors: 1% substitutions, min_count 2 keeps tips (68 unitigs)
        err = name == "errors"
        genome = simulate_genome(2000 if err else 1500, seed=333 if err else 211)
        reads = simulate_reads(genome, coverage=25 if err else 14, read_len=80,
                               seed=334 if err else 212,
                               error_rate=0.01 if err else 0.0).codes
        return reads, AssemblyConfig(k=21, read_len=80, min_count=2 if err else 1)
    rng = np.random.default_rng(15 if name == "repeat" else 7)

    def piece(n):
        return decode_seq(rng.integers(0, 4, n).astype(np.uint8))

    if name == "repeat":
        rep = piece(30)
        genome = piece(220) + rep + piece(200) + rep + piece(180)
        return _tiled(genome, 61), AssemblyConfig(k=21, read_len=61)
    core = piece(260)
    return _tiled(core + core[: 21 + 39], 60), AssemblyConfig(k=21, read_len=60)


def _fit(a, c, fill):
    """[D, C0, ...] -> [D, c, ...]: cut the empty tail or pad with fill."""
    if a.shape[1] >= c:
        return np.ascontiguousarray(a[:, :c])
    pad = np.full((a.shape[0], c - a.shape[1]) + a.shape[2:], fill, a.dtype)
    return np.concatenate([a, pad], axis=1)


@pytest.fixture(scope="module")
def jax_runs():
    """{(workload, d): (words [D, C, W], counts [D, C], JAX compress outputs
    as numpy, JAX spell UnitigArrays)}."""
    import jax.numpy as jnp

    out = {}
    compress_fns = {}
    for d in (2, 4):
        mesh = jax_mesh(d)
        axis = mesh_axes(mesh)
        compress_fns[d] = jax_compress.make_sharded_compress(
            mesh, 21, C_SHARD, axis
        )
        for name in WORKLOADS:
            reads, cfg = _workload(name)
            words, counts, _ = jax_pp._run_distributed_step(
                reads, cfg, mesh, None, axis, None
            )
            words, counts, kept = jax_pp._shard_filter_compact(
                mesh, axis, cfg.min_count
            )(words, counts)
            assert int(np.asarray(kept).max()) < C_SHARD
            words = _fit(np.asarray(words).reshape(d, -1, 2), C_SHARD,
                         np.uint32(0xFFFFFFFF))
            counts = _fit(np.asarray(counts).reshape(d, -1), C_SHARD, 0)
            res = compress_fns[d](jnp.asarray(words.reshape(-1, 2)),
                                  jnp.asarray(counts.reshape(-1)))
            (valid, uid, dist, cov, last_base, heads, edge_words, num,
             overflow) = res
            ua = jax_compress.spell_sharded_arrays(
                mesh, 21, C_SHARD, int(np.asarray(num)[0]),
                valid, uid, dist, cov, heads, edge_words, axis,
            )
            out[name, d] = (words, counts,
                            tuple(np.asarray(x) for x in res), ua)
    return out


def _port_compress(words, counts, d):
    tables = [
        count_torch.count_table_from_numpy(
            words[s], counts[s], int((counts[s] > 0).sum()), False
        )
        for s in range(d)
    ]
    return compress.make_sharded_compress(cpu_mesh(d), 21, C_SHARD)(tables)


def _cat(xs):
    return torch.cat(xs).numpy()


def _assert_ua_equal(a, b):
    for field in ("buf", "off", "edges", "cov_sum"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert a.k == b.k


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name", WORKLOADS)
def test_sharded_compress_equals_jax(jax_runs, name, d):
    words, counts, want, _ = jax_runs[name, d]
    (valid, uid, dist, cov, last_base, heads, edge_words, num,
     overflow) = want
    got = _port_compress(words, counts, d)
    assert len(got.valid) == d and got.valid[0].shape[0] == 2 * C_SHARD
    np.testing.assert_array_equal(_cat(got.valid), valid)
    np.testing.assert_array_equal(_cat(got.uid), uid)
    np.testing.assert_array_equal(_cat(got.pos), dist)
    np.testing.assert_array_equal(_cat(got.cov), cov)
    np.testing.assert_array_equal(_cat(got.last_base), last_base)
    np.testing.assert_array_equal(_cat(got.heads), heads)
    np.testing.assert_array_equal(
        limbs_to_words(_cat(got.edge_limbs), 21), edge_words
    )
    assert got.num_unitigs == int(num[0]) > 0
    assert got.overflow == int(overflow) == 0
    assert got.query_rounds > 0
    assert got.rank_pass == ("exact" if name == "circular" else "sampled")
    if name == "circular":
        # a pure cycle per strand: broken at the minimum global id, then
        # one unitig each
        assert got.num_unitigs == 2


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name", WORKLOADS)
def test_sharded_spell_equals_jax(jax_runs, name, d):
    words, counts, _, want = jax_runs[name, d]
    g = _port_compress(words, counts, d)
    ua = compress.spell_sharded_arrays(
        cpu_mesh(d), 21, C_SHARD, g.num_unitigs, g.valid, g.uid, g.pos,
        g.cov, g.heads, g.edge_limbs,
    )
    _assert_ua_equal(ua, want)


def test_sharded_spell_tiny_u_block_retries(jax_runs):
    """u_block=4 overflows (many unitigs on 2 shards) and must retry to
    the same arrays: the JAX package's at the default u_block and at 4."""
    import jax.numpy as jnp

    words, counts, res, want = jax_runs["errors", 2]
    g = _port_compress(words, counts, 2)
    assert g.num_unitigs > 8
    m = Metrics()
    ua = compress.spell_sharded_arrays(
        cpu_mesh(2), 21, C_SHARD, g.num_unitigs, g.valid, g.uid, g.pos,
        g.cov, g.heads, g.edge_limbs, u_block=4, metrics=m,
    )
    _assert_ua_equal(ua, want)
    one_try = compress.wire_bytes(2, 21, C_SHARD, 4)["spell"]
    assert m.counters["a2a_bytes_spell"] > one_try  # it retried
    valid, uid, dist, cov, _, heads, edge_words, num, _ = res
    jax_small = jax_compress.spell_sharded_arrays(
        jax_mesh(2), 21, C_SHARD, int(num[0]),
        *(jnp.asarray(x) for x in (valid, uid, dist, cov, heads, edge_words)),
        mesh_axes(jax_mesh(2)), u_block=4,
    )
    _assert_ua_equal(ua, jax_small)


ASSEMBLY_CFG = AssemblyConfig(k=31, read_len=100, min_count=0)


@pytest.fixture(scope="module")
def assembly_reads():
    genome = simulate_genome(2500, seed=51)
    return simulate_reads(genome, coverage=20, read_len=100, seed=52,
                          error_rate=0.005).codes


@pytest.fixture(scope="module")
def jax_sharded(assembly_reads, tmp_path_factory):
    """The JAX package's sharded contigs (auto min_count, 4 devices) and
    the "hash_shards" checkpoint it wrote."""
    ckpt = str(tmp_path_factory.mktemp("jax") / "sh.npz")
    contigs = jax_pp.assemble_distributed_sharded(
        assembly_reads, ASSEMBLY_CFG, jax_mesh(4), checkpoint=ckpt
    )
    return contigs, ckpt


@pytest.fixture(scope="module")
def oracle_contigs(assembly_reads):
    return assemble_oracle(assembly_reads, ASSEMBLY_CFG)


@pytest.mark.parametrize("variant", ["auto", "minimizer", "streamed"])
@pytest.mark.parametrize("d", [2, 4])
def test_assemble_sharded_equals_jax_oracle_and_gathered(
    assembly_reads, jax_sharded, oracle_contigs, monkeypatch, d, variant
):
    minimizer = 15 if variant == "minimizer" else None
    cfg = ASSEMBLY_CFG
    if variant == "streamed":
        monkeypatch.setattr(pp, "DIST_STREAM_WINDOWS", 0)
        cfg = AssemblyConfig(k=31, read_len=100, min_count=0, batch_reads=96)
    m = Metrics()
    mesh = cpu_mesh(d)
    got = pp.assemble_distributed_sharded(
        assembly_reads, cfg, mesh, metrics=m, minimizer_len=minimizer,
        table_capacity=8192 if variant == "streamed" else None,
    )
    assert got == jax_sharded[0]
    assert got == oracle_contigs
    assert got == pp.assemble_distributed(assembly_reads, cfg, mesh,
                                          minimizer_len=minimizer)
    assert got
    assert m.counters["shards"] == d
    for name in ("a2a_bytes_count", "a2a_bytes_compress_link",
                 "a2a_bytes_compress_query_round", "a2a_bytes_spell"):
        assert m.counters[name] > 0
    assert 0 < m.counters["a2a_compress_query_rounds"]
    assert (m.counters["a2a_compress_query_rounds"]
            <= 3 * m.counters["a2a_compress_query_rounds_max"] + 2)
    assert {"count", "filter", "compress", "spell", "simplify",
            "traverse"} <= set(m.stages)


def test_sharded_checkpoint_crosses_both_packages(
    assembly_reads, jax_sharded, tmp_path
):
    jax_contigs, jax_ckpt = jax_sharded
    zeros = np.zeros_like(assembly_reads)
    mesh = cpu_mesh(4)
    # the JAX package's file resumes in the port
    assert pp.assemble_distributed_sharded(
        zeros, ASSEMBLY_CFG, mesh, resume_from=jax_ckpt
    ) == jax_contigs
    # the port writes the same arrays, and its file resumes in JAX
    ckpt = str(tmp_path / "port.npz")
    assert pp.assemble_distributed_sharded(
        assembly_reads, ASSEMBLY_CFG, mesh, checkpoint=ckpt
    ) == jax_contigs
    with np.load(ckpt) as a, np.load(jax_ckpt) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])
    assert jax_pp.assemble_distributed_sharded(
        zeros, ASSEMBLY_CFG, jax_mesh(4), resume_from=ckpt
    ) == jax_contigs
    # a mismatched shard count is a clear error; so is the wrong backend
    with pytest.raises(ValueError, match="d=4"):
        pp.assemble_distributed_sharded(zeros, ASSEMBLY_CFG, cpu_mesh(2),
                                        resume_from=ckpt)
    with pytest.raises(ValueError, match="sharded-graph"):
        pp.assemble_distributed(zeros, ASSEMBLY_CFG, mesh, resume_from=ckpt)


def test_node_owner_equals_jax_on_the_r4_genome():
    """The salted node-owner hash over the four node types of the r4
    regression genome (``test_sharded_compress.py``): the port's owners
    equal the JAX package's, and none correlates with the home shard."""
    import jax.numpy as jnp

    from genome_assembler_tpu.ops.hash import mix_words
    from genome_assembler_tpu.ops.kmer_ref import extract_canonical_np
    from genome_assembler_tpu.ops.words_jax import (
        prefix_node,
        revcomp_words,
        suffix_node,
    )
    from genome_assembler_tpu_torch.ops import hash_torch, words_torch
    from genome_assembler_tpu_torch.utils.keys import words_to_limbs

    k, d = 31, 8
    genome = simulate_genome(100_000, seed=1050)
    keys = np.unique(extract_canonical_np(genome[None, :], k), axis=0)
    words = jnp.asarray(keys)
    limbs = torch.from_numpy(words_to_limbs(keys))
    home = hash_torch.owner_of(limbs, k, d).numpy()
    rc_w, rc_l = revcomp_words(words, k), words_torch.revcomp_words(limbs, k)
    salt = jnp.uint32(0x5BD1E995)
    for jw, pl in (
        (prefix_node(words, k), words_torch.prefix_node(limbs, k)),
        (suffix_node(words, k), words_torch.suffix_node(limbs, k)),
        (prefix_node(rc_w, k), words_torch.prefix_node(rc_l, k)),
        (suffix_node(rc_w, k), words_torch.suffix_node(rc_l, k)),
    ):
        want = np.asarray(mix_words(jw ^ salt) % jnp.uint32(d))
        got = compress.node_owner(pl, k, d).numpy()
        np.testing.assert_array_equal(got, want)
        assert float((got == home).mean()) < 0.15


@pytest.mark.parametrize("d,c_shard", [(1, 1 << 20), (2, 1 << 19), (4, 3_145_728),
                                       (8, 1 << 17), (3, 5000)])
def test_shape_arithmetic_equals_reference(d, c_shard):
    assert compress.peak_rows_per_device(d, c_shard) == (
        jax_compress.peak_rows_per_device(d, c_shard)
    )
    for k in (21, 31, 41):
        for ub in (None, 4, 1 << 12):
            assert compress.comm_bytes_estimate(d, k, c_shard, ub) == (
                jax_compress.comm_bytes_estimate(d, k, c_shard, ub)
            )
    assert compress._join_cap(2 * c_shard, d) == jax_compress._join_cap(
        2 * c_shard, d
    )
    # the port's own wire: int64 lanes, so wider than the reference's
    wire = compress.wire_bytes(d, 31, c_shard)
    est = compress.comm_bytes_estimate(d, 31, c_shard)
    for name in ("link", "query_round", "spell"):
        assert wire[name] > est[name]


@pytest.mark.parametrize("cap,name", [("_join_cap", "link-join"),
                                      ("_pair_cap", "link-pair"),
                                      ("_query_cap", "rank-query")])
def test_tiny_cap_raises_named_overflow(assembly_reads, monkeypatch, cap, name):
    monkeypatch.setattr(compress, cap, lambda k_cap, d: 2)
    with pytest.raises(RuntimeError, match=f"routing overflow in .*{name}"):
        pp.assemble_distributed_sharded(assembly_reads, ASSEMBLY_CFG,
                                        cpu_mesh(4))


def test_even_k_raises(assembly_reads):
    with pytest.raises(ValueError, match="odd k"):
        pp.assemble_distributed_sharded(
            assembly_reads, AssemblyConfig(k=24, read_len=100), cpu_mesh(2)
        )


def test_mesh_collectives_and_two_devices(assembly_reads, oracle_contigs):
    """The replicated gather and the max-reduce on one device and across
    two (``cpu`` and ``cpu:0`` are two devices to the mesh, which drives
    the per-pair copy path), then the sharded assembly on two devices."""
    xs = [torch.tensor([3, 1]), torch.tensor([7, 2])]
    for devices in (["cpu"], ["cpu", "cpu:0"]):
        mesh = mesh_mod.build_mesh(2, devices=devices)
        got = mesh_mod.all_gather_replicated(mesh, xs)
        assert len(got) == 2
        for g, dev in zip(got, mesh.devices):
            assert g.device.type == dev.type and g.tolist() == [3, 1, 7, 2]
        assert int(mesh_mod.max_reduce(mesh, [torch.tensor(4),
                                              torch.tensor(9)])) == 9
    mesh = mesh_mod.build_mesh(4, devices=["cpu", "cpu:0"])
    assert not mesh.single_device
    assert pp.assemble_distributed_sharded(
        assembly_reads, ASSEMBLY_CFG, mesh
    ) == oracle_contigs


def test_cli_sharded_graph(tmp_path, assembly_reads):
    reads_file = tmp_path / "reads.txt"
    reads_file.write_text(
        "\n".join(decode_seq(r) for r in assembly_reads[:300]) + "\n"
    )
    out, metrics = str(tmp_path / "c.fa"), str(tmp_path / "m.json")
    base = ["assemble", "--reads", str(reads_file), "-k", "25",
            "--device", "cpu", "--out", out]
    assert cli.main(base + ["--backend", "dist", "--devices", "4",
                            "--sharded-graph", "--metrics-out", metrics]) == 0
    want = assemble_oracle(assembly_reads[:300],
                           AssemblyConfig(k=25, read_len=100))
    assert read_sequences(out) == want
    report = json.loads(open(metrics).read())
    assert report["shards"] == 4
    assert report["counters"]["a2a_bytes_compress_link"] > 0
    # --sharded-graph shards the graph of the dist backend only
    out2 = tmp_path / "c2.fa"
    assert cli.main(["assemble", "--reads", str(reads_file), "-k", "25",
                     "--device", "cpu", "--out", str(out2),
                     "--sharded-graph"]) == 2
    assert not out2.exists()
