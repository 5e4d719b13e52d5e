"""The port's sampled two-level ranking against the JAX package's, on one
device (``ops/unitig_torch.py``) and sharded (``parallel/compress.py``).

The same predecessor arrays, made from numpy seeds (chains in shuffled id
order, cycles with and without rulers, self-loops, one large cycle), go
through ``unitig_jax._rank_sampled`` / ``_rank_sampled_cyclic`` and the
port's versions: head, rank, ok and the broken predecessors are equal.
``compress_unitigs_device`` of both packages, with ``SAMPLED_MIN_ROWS``
set to 0, gives bit-equal DeviceUnitigs, and so does the port's exact
pass. The sharded sampled compress at D in {2, 4} on the CPU mesh equals
the JAX package's and the port's forced exact pass, with fewer query
rounds on a graph of long chains, and so does the smoke script's
phase-14 rank job run as two gloo ranks. Exact everywhere.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genome_assembler_tpu.parallel.compress as jax_compress
from genome_assembler_tpu.models.pipeline import count_reads_device
from genome_assembler_tpu.ops import count_jax, unitig_jax
from genome_assembler_tpu.parallel.mesh import build_mesh as jax_mesh
from genome_assembler_tpu.parallel.mesh import mesh_axes
from genome_assembler_tpu.utils.config import AssemblyConfig
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads
from genome_assembler_tpu_torch.ops import count_torch, unitig_torch
from genome_assembler_tpu_torch.parallel import compress, launch
from genome_assembler_tpu_torch.parallel import pipeline as pp
from genome_assembler_tpu_torch.parallel.mesh import build_mesh
from genome_assembler_tpu_torch.utils.keys import limbs_to_words

torch.set_num_threads(1)


def _chains_and_cycles(seed, n, nchains, ncycles):
    """prev[] of nchains chains and ncycles pure cycles over a shuffled
    id space (the reference test's ``_mixed_prev``)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    prev = np.full(n, -1, np.int32)
    for i, part in enumerate(np.array_split(order, nchains + ncycles)):
        if len(part) > 1:
            prev[part[1:]] = part[:-1]
            if i >= nchains:
                prev[part[0]] = part[-1]
    return prev


def _ruler_free_cycle(n, cyc, chain=True):
    """One cycle over the ids ``cyc`` (no multiple of 32 among them), the
    other ids one chain in id order (or heads)."""
    prev = np.full(n, -1, np.int32)
    if chain:
        rest = [i for i in range(n) if i not in set(cyc)]
        prev[rest[1:]] = rest[:-1]
    for i, e in enumerate(cyc):
        prev[e] = cyc[i - 1]
    return prev


def _self_loop(n, at):
    prev = np.full(n, -1, np.int32)
    prev[at] = at
    return prev


CASES = {
    "one_chain_in_id_order": lambda: np.arange(-1, 299, dtype=np.int32),
    "shuffled_chains": lambda: _chains_and_cycles(42, 500, 3, 0),
    "many_short_chains": lambda: _chains_and_cycles(9, 700, 40, 0),
    "one_long_shuffled_chain": lambda: _chains_and_cycles(3, 4000, 1, 0),
    "chains_and_cycles": lambda: _chains_and_cycles(5, 800, 2, 3),
    "cycles_only": lambda: _chains_and_cycles(11, 650, 0, 4),
    "one_big_cycle": lambda: np.roll(np.arange(600, dtype=np.int32), 1),
    "cycle_through_one_ruler": lambda: np.roll(np.arange(200, dtype=np.int32), 1),
    "ruler_free_cycle": lambda: _ruler_free_cycle(
        200, [33, 37, 41, 45, 49, 53, 57, 61]),
    "ruler_free_cycle_beside_a_chain": lambda: _ruler_free_cycle(
        40, list(range(5, 13))),
    "self_loop": lambda: _self_loop(64, 33),
    "self_loop_on_a_ruler": lambda: _self_loop(100, 64),
}


def _both(prev_np):
    return jnp.asarray(prev_np), torch.from_numpy(prev_np.astype(np.int64))


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank_sampled_equals_jax(case):
    jp, tp = _both(CASES[case]())
    jh, jr, jo = unitig_jax._rank_sampled(jp)
    rounds = {}
    th, tr, to = unitig_torch._rank_sampled(tp, rounds)
    assert to == bool(jo)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert 1 <= rounds["a"] <= unitig_torch.SAMPLED_MAX_ROUNDS
    if to:
        # equal to the exact pass on every lane
        anc, dist, has_cycle = unitig_torch._rank_pass(tp)
        assert not has_cycle
        assert torch.equal(th, anc) and torch.equal(tr, dist)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank_sampled_cyclic_equals_jax(case):
    jp, tp = _both(CASES[case]())
    jh, jr, jo, jprev = unitig_jax._rank_sampled_cyclic(jp)
    th, tr, to, tprev = unitig_torch._rank_sampled_cyclic(tp)
    assert to == bool(jo)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tprev.numpy(), np.asarray(jprev))
    if to:
        valid = torch.ones(tp.shape[0], dtype=torch.bool)
        got = unitig_torch._finalize_chains(tprev, th, tr, valid)
        want = unitig_torch._resolve_exact(tp, valid)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_ok_refusals_match_the_reference_semantics():
    """Which case each pass refuses: a cycle through the rulers refuses
    the sampled pass only; a cycle without a ruler, and a self-loop,
    refuse both."""
    ok = {name: (unitig_torch._rank_sampled(_both(f())[1])[2],
                 unitig_torch._rank_sampled_cyclic(_both(f())[1])[2])
          for name, f in CASES.items()}
    assert ok["shuffled_chains"] == (True, True)
    assert ok["one_big_cycle"] == (False, True)
    assert ok["cycle_through_one_ruler"] == (False, True)
    for name in ("ruler_free_cycle", "ruler_free_cycle_beside_a_chain",
                 "self_loop"):
        assert ok[name] == (False, False), name


def _reads(name):
    """(reads, k, min_count) of the compress workloads."""
    if name == "linear":
        genome = simulate_genome(1500, seed=71)
        return simulate_reads(genome, coverage=10, read_len=61,
                              seed=72).codes, 31, 1
    if name == "errors":
        genome = simulate_genome(1500, seed=73)
        return simulate_reads(genome, coverage=25, read_len=80, seed=74,
                              error_rate=0.01).codes, 21, 2
    genome = simulate_genome(1200, seed=23)
    return simulate_reads(genome, coverage=8, read_len=61, seed=24,
                          tile_k=31, circular=True).codes, 31, 1


@pytest.mark.parametrize("name,want_pass", [
    ("linear", "sampled"), ("errors", "sampled"), ("circular", "cyclic"),
])
def test_compress_unitigs_device_sampled_equals_jax(monkeypatch, name,
                                                    want_pass):
    reads, k, min_count = _reads(name)
    cfg = AssemblyConfig(k=k, read_len=reads.shape[1])
    jt = count_jax.filter_table(count_reads_device(reads, cfg), min_count)
    pt = count_torch.count_table_from_numpy(
        np.asarray(jt.words), np.asarray(jt.counts), int(jt.num_unique),
        bool(jt.overflow))
    monkeypatch.setattr(unitig_jax, "SAMPLED_MIN_ROWS", 0)
    monkeypatch.setattr(unitig_torch, "SAMPLED_MIN_ROWS", 0)
    jd = unitig_jax.compress_unitigs_device(jt, k)
    rounds = {}
    pd = unitig_torch.compress_unitigs_device(pt, k, rounds=rounds)
    assert rounds["pass"] == want_pass
    exact_rounds = {}
    pe = unitig_torch.compress_unitigs_device(pt, k, rounds=exact_rounds,
                                              _exact=True)
    assert exact_rounds["pass"] == "exact"
    np.testing.assert_array_equal(
        limbs_to_words(pd.edge_limbs.numpy(), k), np.asarray(jd.edge_words))
    for field in ("cov", "uid", "pos", "valid"):
        np.testing.assert_array_equal(getattr(pd, field).numpy(),
                                      np.asarray(getattr(jd, field)))
        assert torch.equal(getattr(pd, field), getattr(pe, field))
    assert int(pd.num_unitigs) == int(jd.num_unitigs) == int(pe.num_unitigs)


def test_below_the_bound_takes_the_exact_pass():
    genome = simulate_genome(600, seed=5)
    reads = simulate_reads(genome, coverage=8, read_len=61, seed=6).codes
    jt = count_reads_device(reads, AssemblyConfig(k=31, read_len=61))
    pt = count_torch.count_table_from_numpy(
        np.asarray(jt.words), np.asarray(jt.counts), int(jt.num_unique),
        bool(jt.overflow))
    rounds = {}
    unitig_torch.compress_unitigs_device(pt, 31, rounds=rounds)
    assert 2 * pt.limbs.shape[0] < unitig_torch.SAMPLED_MIN_ROWS
    assert rounds["pass"] == "exact" and rounds["exact"] > 0
    assert unitig_torch.SAMPLED_MIN_ROWS == unitig_jax.SAMPLED_MIN_ROWS
    assert unitig_torch.SAMPLE_STRIDE == unitig_jax.SAMPLE_STRIDE
    assert unitig_torch.SAMPLED_MAX_ROUNDS == unitig_jax.SAMPLED_MAX_ROUNDS


# ---- the sharded graph ----

C_SHARD = 4096  # k_cap 8192: a multiple of the stride, so both sample


def _shard_tables(name, d):
    """Per-shard filtered tables of C_SHARD rows (the port's count on a CPU
    mesh, cut to one capacity) as reference words and counts."""
    if name == "long_chains":
        genome = simulate_genome(6000, seed=91)
        reads = simulate_reads(genome, coverage=8, read_len=80,
                               seed=92).codes
    else:
        rng = np.random.default_rng(7)
        core = rng.integers(0, 4, 260).astype(np.uint8)
        seq = np.concatenate([core, core[:60]])
        reads = np.stack([seq[i : i + 60] for i in range(len(seq) - 59)])
    cfg = AssemblyConfig(k=21, read_len=reads.shape[1])
    tables = pp._shard_filter_compact(
        pp._run_distributed_step(reads, cfg, build_mesh(d, devices=["cpu"])),
        1)
    words = np.full((d, C_SHARD, 2), 0xFFFFFFFF, np.uint32)
    counts = np.zeros((d, C_SHARD), np.int32)
    for s, t in enumerate(tables):
        n = int(t.num_unique)
        assert n < C_SHARD
        words[s, :n] = limbs_to_words(t.limbs[:n].numpy(), 21)
        counts[s, :n] = t.counts[:n].numpy()
    return words, counts


@pytest.fixture(scope="module")
def jax_compress_fns():
    return {d: jax_compress.make_sharded_compress(
        jax_mesh(d), 21, C_SHARD, mesh_axes(jax_mesh(d))) for d in (2, 4)}


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name", ["long_chains", "circular"])
def test_sharded_sampled_equals_jax_and_exact(jax_compress_fns, name, d):
    words, counts = _shard_tables(name, d)
    want = [np.asarray(x) for x in jax_compress_fns[d](
        jnp.asarray(words.reshape(-1, 2)), jnp.asarray(counts.reshape(-1)))]
    tables = [count_torch.count_table_from_numpy(
        words[s], counts[s], int((counts[s] > 0).sum()), False)
        for s in range(d)]
    mesh = build_mesh(d, devices=["cpu"])
    got = compress.make_sharded_compress(mesh, 21, C_SHARD)(tables)
    exact = compress.make_sharded_compress(mesh, 21, C_SHARD,
                                           _exact=True)(tables)
    valid, uid, dist, cov, last_base, heads, edge_words, num, ovf = want
    for g in (got, exact):
        np.testing.assert_array_equal(torch.cat(g.valid).numpy(), valid)
        np.testing.assert_array_equal(torch.cat(g.uid).numpy(), uid)
        np.testing.assert_array_equal(torch.cat(g.pos).numpy(), dist)
        np.testing.assert_array_equal(torch.cat(g.cov).numpy(), cov)
        np.testing.assert_array_equal(torch.cat(g.heads).numpy(), heads)
        np.testing.assert_array_equal(
            limbs_to_words(torch.cat(g.edge_limbs).numpy(), 21), edge_words)
        assert g.num_unitigs == int(num[0]) and g.overflow == int(ovf) == 0
    assert exact.rank_pass == "exact" and exact.contracted_rounds == 0
    if name == "long_chains":
        assert got.rank_pass == "sampled" and got.contracted_rounds > 0
        # ceil(log2(largest ruler gap)) rounds, not ceil(log2(chain))
        assert got.doubling_rounds < exact.doubling_rounds
        assert got.query_rounds < exact.query_rounds
    else:
        # a cycle through the rulers: the sampled pass refuses, the exact
        # pass breaks it at its smallest global id
        assert got.rank_pass == "exact" and got.num_unitigs == 2
        assert got.query_rounds > exact.query_rounds


def test_sharded_takes_the_exact_pass_off_the_stride_grid():
    """K not a multiple of the stride: the reference's rule is the exact
    pass (``compress.py:395``), with the same outputs."""
    words, counts = _shard_tables("long_chains", 2)
    c = C_SHARD - 4  # k_cap 8184 = 8 (mod 32)
    tables = [count_torch.count_table_from_numpy(
        words[s, :c], counts[s, :c], int((counts[s] > 0).sum()), False)
        for s in range(2)]
    mesh = build_mesh(2, devices=["cpu"])
    got = compress.make_sharded_compress(mesh, 21, c)(tables)
    assert got.rank_pass == "exact"
    assert not compress.make_sharded_compress(mesh, 21, 48).use_sampled
    assert compress.make_sharded_compress(mesh, 21, 64).use_sampled



def test_smoke_rank_compress_job_across_two_gloo_ranks(tmp_path):
    """``chip_smoke.py --rank-compress``, the job phase 14 starts on every
    card: as two CPU ranks over gloo (4 shards, 2 a rank) it takes the
    sampled pass, equals the forced exact pass in fewer query rounds, and
    rank 0 writes the numbers."""
    genome = simulate_genome(6000, seed=91)
    reads = simulate_reads(genome, coverage=8, read_len=80, seed=92).codes
    reads_file, out = str(tmp_path / "reads.txt"), str(tmp_path / "rc.json")
    launch.write_reads_lines(reads_file, reads)
    smoke = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    res = launch.spawn(2, [reads_file, out, "16384"], device="cpu",
                       timeout_s=240, entry=(smoke, "--rank-compress"))
    assert res.ok, res.describe()
    with open(out) as fh:
        got = json.load(fh)
    assert got["ranks"] == 2 and got["outputs_equal"]
    assert got["c_shard"] * 2 % unitig_torch.SAMPLE_STRIDE == 0
    sampled, exact = got["sampled"], got["exact"]
    assert sampled["rank_pass"] == "sampled" and exact["rank_pass"] == "exact"
    assert sampled["query_rounds"] < exact["query_rounds"]
    assert len(sampled["compress_s"]) == len(exact["compress_s"]) == 3
