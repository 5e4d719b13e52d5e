"""The host graph's strings, built by byte-table translation, against the
JAX package's: ``revcomp_str`` and ``canonical_str`` (whose strand is
decided from the two ends), the unitig decode, and both
emission modes on strand-symmetric graphs of unitigs 100 kb and longer;
and the ``revcomp_bases`` counter of both pipelines."""

import numpy as np
import pytest

import genome_assembler_tpu.host.dbg as jax_dbg
import genome_assembler_tpu.host.simplify_arrays as jax_sa
import genome_assembler_tpu.host.traverse as jax_traverse
import genome_assembler_tpu.utils.dna as jax_dna
import genome_assembler_tpu_torch.host.dbg as dbg
import genome_assembler_tpu_torch.host.simplify_arrays as sa
import genome_assembler_tpu_torch.host.traverse as traverse
import genome_assembler_tpu_torch.models.pipeline as pipeline
import genome_assembler_tpu_torch.parallel.pipeline as pp
import genome_assembler_tpu_torch.utils.dna as dna
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads
from genome_assembler_tpu_torch.parallel.mesh import build_mesh
from genome_assembler_tpu_torch.utils.config import AssemblyConfig
from genome_assembler_tpu_torch.utils.metrics import Metrics

K = 31


def _random(n, seed):
    rng = np.random.default_rng(seed)
    return jax_dna.decode_seq(rng.integers(0, 4, n))


def _assert_strands_equal(s):
    assert dna.revcomp_str(s) == jax_dna.revcomp_str(s)
    got, want = dna.canonical_str(s), jax_dna.canonical_str(s)
    assert got == want
    canon, flipped = dna.canonical_str_flipped(s)
    assert canon == want and flipped == (want != s)


# ------------------------------------------------------ revcomp and canonical

@pytest.mark.parametrize("n", [0, 1, 2, 21, 31, 63, 64, 65, 127, 128, 255,
                               256, 257, 1000, 1025, 4096, 5000])
def test_random_strings_equal(n):
    for seed in range(4):
        _assert_strands_equal(_random(n, 100 * n + seed))


@pytest.mark.parametrize("n", [1, 31, 64, 65, 300, 5000])
@pytest.mark.parametrize("case", ["lower", "mixed"])
def test_lower_and_mixed_case_equal(case, n):
    rng = np.random.default_rng(n)
    for seed in range(3):
        s = _random(n, seed + n)
        if case == "lower":
            s = s.lower()
        else:
            s = "".join(c.lower() if f else c
                        for c, f in zip(s, rng.random(n) < 0.5))
        _assert_strands_equal(s)
        assert dna.revcomp_str(s).isupper() or n == 0


@pytest.mark.parametrize("half", [1, 32, 64, 65, 512, 2500])
def test_even_palindromes_equal(half):
    x = _random(half, half)
    s = x + jax_dna.revcomp_str(x)
    assert jax_dna.revcomp_str(s) == s
    _assert_strands_equal(s)
    assert dna.canonical_str_flipped(s) == (s, False)


@pytest.mark.parametrize("agree", [63, 64, 65, 256, 1025])
@pytest.mark.parametrize("middle", [1, 2, 100, 3000])
def test_head_equal_to_the_tails_revcomp_equal(agree, middle):
    """The head equals the tail's reverse complement for ``agree`` bases,
    so the strand is decided at a window's edge or past it."""
    h = _random(agree, agree + middle)
    for seed in range(4):
        s = h + _random(middle, seed + 7 * middle) + jax_dna.revcomp_str(h)
        _assert_strands_equal(s)
        _assert_strands_equal(jax_dna.revcomp_str(s))


def _error(fn, s):
    with pytest.raises(ValueError) as e:
        fn(s)
    return str(e.value)


@pytest.mark.parametrize("bad", ["N", "X", "é", "n", "\x00"])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("n", [10, 300])
def test_non_acgt_raises_the_same_error(bad, where, n):
    s = _random(n, n)
    at = {"first": 0, "middle": n // 2, "last": n - 1}[where]
    s = s[:at] + bad + s[at + 1 :]
    if where != "last":
        s = s[:-1] + "X"  # a second bad character: the first is named
    for fn, ref in ((dna.revcomp_str, jax_dna.revcomp_str),
                    (dna.canonical_str, jax_dna.canonical_str)):
        assert _error(fn, s) == _error(ref, s)
        assert repr(bad) in _error(fn, s)


# ------------------------------------------------------------ unitig decode

def _arrays(pkg, buf, lens):
    off = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    return pkg.UnitigArrays(
        buf=buf, off=off, edges=np.asarray(lens, dtype=np.int64) - (K - 1),
        cov_sum=np.arange(len(lens), dtype=np.int64) * 7 + 40, k=K)


@pytest.mark.parametrize("lens", [[31], [31, 200, 31], [100_000, 150_031],
                                  [31 + i % 97 for i in range(500)]],
                         ids=["one", "three", "long", "many"])
def test_to_unitig_list_equal_on_codes_0_to_4(lens):
    rng = np.random.default_rng(len(lens))
    buf = rng.integers(0, 5, sum(lens), dtype=np.uint8)
    got = sa.to_unitig_list(_arrays(sa, buf, lens))
    want = jax_sa.to_unitig_list(_arrays(jax_sa, buf, lens))
    assert [(u.seq, u.cov_sum, u.edges, u.k) for u in got] == [
        (u.seq, u.cov_sum, u.edges, u.k) for u in want]
    ua = _arrays(sa, buf, lens)
    assert [ua.seq(i) for i in range(len(lens))] == [u.seq for u in got]
    bad = buf.copy()
    bad[-1] = 5
    for pkg in (sa, jax_sa):
        with pytest.raises(IndexError):
            pkg.to_unitig_list(_arrays(pkg, bad, lens))
    with pytest.raises(IndexError):
        dna.decode_seq(bad)


# ------------------------------------------------------------- emission

def _graph_seqs(kind):
    """Strand-symmetric unitig strings, each 100 kb or longer: every
    unitig with its reverse-complement twin."""
    seqs = [_random(100_000 + 1_000 * i, 40 + i) for i in range(4)]
    h = _random(1_025, 3)
    seqs.append(h + _random(100_000, 4) + jax_dna.revcomp_str(h))
    if kind in ("palindrome", "both"):
        x = _random(60_000, 5)
        seqs.append(x + jax_dna.revcomp_str(x))
    if kind in ("circular", "both"):
        core = _random(120_000, 6)
        seqs.append(core + core[: K - 1])
    out = []
    for s in seqs:
        out.append(s)
        rc = jax_dna.revcomp_str(s)
        if rc != s:
            out.append(rc)
    return out


def _graph(pkg, seqs):
    return pkg.build_unitig_graph(
        [pkg.Unitig(seq=s, cov_sum=3 * len(s) + i, edges=len(s) - K + 1, k=K)
         for i, s in enumerate(seqs)], K)


def _expected_revcomp_bases(g):
    total = 0
    for u in g.unitigs:
        if u.start == u.end and u.edges > 1:
            total += len(u.seq) - (K - 1)
        elif jax_dna.canonical_str(u.seq) != u.seq:
            total += len(u.seq)
    return total


@pytest.mark.parametrize("kind", ["linear", "palindrome", "circular", "both"])
@pytest.mark.parametrize("mode", ["unitigs", "euler"])
def test_emission_equal_on_long_strand_symmetric_graphs(mode, kind):
    seqs = _graph_seqs(kind)
    g, jg = _graph(dbg, seqs), _graph(jax_dbg, seqs)
    if mode == "unitigs":
        emit, ref = (traverse.emit_contigs_with_cov,
                     jax_traverse.emit_contigs_with_cov)
    else:
        emit, ref = (traverse.emit_contigs_euler_with_cov,
                     jax_traverse.emit_contigs_euler_with_cov)
    m = Metrics()
    with traverse.counted_into(m):
        got = emit(g)
    assert got == ref(jg)
    assert all(type(s) is str for s, _ in got)
    counted = m.counters["revcomp_bases"]
    # outside the block emission counts nothing
    assert emit(g) == got and m.counters["revcomp_bases"] == counted
    if mode == "unitigs":
        assert counted == _expected_revcomp_bases(g)
    else:
        assert counted > 0


# ------------------------------------------------- the pipelines' counter

@pytest.fixture(scope="module")
def small_reads():
    genome = simulate_genome(3000, seed=18)
    return simulate_reads(genome, coverage=20, read_len=100, seed=19,
                          tile_k=K).codes


def _assert_half_flipped(m, graph):
    bases = sum(len(u.seq) for u in graph.unitigs)
    assert graph.unitigs and bases % 2 == 0
    # odd k: no unitig is its own reverse complement, so one of each twin
    # pair is emitted from its other strand
    assert m.counters["revcomp_bases"] == _expected_revcomp_bases(graph)
    assert m.counters["revcomp_bases"] == bases // 2


@pytest.mark.parametrize("emit", ["unitigs", "euler"])
def test_single_device_pipeline_counts_revcomp_bases(small_reads, emit):
    m = Metrics()
    cfg = AssemblyConfig(k=K, read_len=100)
    contigs, graph = pipeline.assemble_torch(
        small_reads, cfg, device="cpu", metrics=m, return_graph=True,
        emit=emit)
    assert contigs
    if emit == "unitigs":
        _assert_half_flipped(m, graph)
    else:
        assert 0 < m.counters["revcomp_bases"]


def test_sharded_pipeline_counts_revcomp_bases(small_reads):
    m = Metrics()
    cfg = AssemblyConfig(k=K, read_len=100)
    contigs, graph = pp.assemble_distributed_sharded(
        small_reads, cfg, build_mesh(2, devices=["cpu"]), metrics=m,
        return_graph=True)
    assert contigs == pipeline.assemble_torch(small_reads, cfg, device="cpu")
    _assert_half_flipped(m, graph)
