"""The port's own copies of the framework-free modules against their
originals in ``genome_assembler_tpu``: the same seeded inputs through
both, results equal (exact: these are integers, arrays and strings).
Covers ``utils.dna``, ``utils.simulate``, ``ops.kmer_ref``, the host graph
stages (``host.dbg``, ``host.simplify_arrays``, ``host.simplify``,
``host.traverse``, ``host.stats``), ``models.oracle``, the CLI's read and
FASTA helpers and ``utils.io_native``."""

import io

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import genome_assembler_tpu.cli as jax_cli
import genome_assembler_tpu.host.dbg as jax_dbg
import genome_assembler_tpu.host.simplify as jax_simplify
import genome_assembler_tpu.host.simplify_arrays as jax_sa
import genome_assembler_tpu.host.stats as jax_stats
import genome_assembler_tpu.host.traverse as jax_traverse
import genome_assembler_tpu.models.oracle as jax_oracle
import genome_assembler_tpu.models.pipeline as jax_pipeline
import genome_assembler_tpu.ops.kmer_ref as jax_kmer_ref
import genome_assembler_tpu.utils.config as jax_config
import genome_assembler_tpu.utils.dna as jax_dna
import genome_assembler_tpu.utils.io_native as jax_io
import genome_assembler_tpu.utils.metrics as jax_metrics
import genome_assembler_tpu.utils.simulate as jax_sim
import genome_assembler_tpu_torch.cli as cli
import genome_assembler_tpu_torch.host.dbg as dbg
import genome_assembler_tpu_torch.host.simplify as simplify
import genome_assembler_tpu_torch.host.simplify_arrays as sa
import genome_assembler_tpu_torch.host.stats as stats
import genome_assembler_tpu_torch.host.traverse as traverse
import genome_assembler_tpu_torch.models.oracle as oracle
import genome_assembler_tpu_torch.models.pipeline as pipeline
import genome_assembler_tpu_torch.ops.kmer_ref as kmer_ref
import genome_assembler_tpu_torch.utils.config as config
import genome_assembler_tpu_torch.utils.dna as dna
import genome_assembler_tpu_torch.utils.io_native as io_native
import genome_assembler_tpu_torch.utils.metrics as metrics
import genome_assembler_tpu_torch.utils.simulate as sim

dna_strings = st.text(alphabet="ACGT", min_size=1, max_size=60)


def _reads(seed, glen=2500, coverage=30, read_len=80, k=21, error_rate=0.0,
           n_rate=0.0, circular=False):
    genome = jax_sim.simulate_genome(glen, seed=seed)
    rs = jax_sim.simulate_reads(genome, coverage=coverage, read_len=read_len,
                                seed=seed + 1, error_rate=error_rate,
                                tile_k=k, circular=circular)
    reads = rs.codes.copy()
    if n_rate:
        reads[np.random.default_rng(seed).random(reads.shape) < n_rate] = 4
    return reads, genome


def _graph_view(g):
    """A UnitigGraph as plain data (the two packages' dataclasses are
    different types)."""
    return (
        g.k,
        [(u.seq, u.cov_sum, u.edges, u.k) for u in g.unitigs],
        g.out_adj,
        g.in_adj,
    )


# ---------------------------------------------------------------- utils.dna

def test_dna_constants_equal():
    assert dna.INVALID_CODE == jax_dna.INVALID_CODE
    assert np.array_equal(dna._DECODE_LUT, jax_dna._DECODE_LUT)
    assert [dna.key_words(k) for k in range(1, 64)] == [
        jax_dna.key_words(k) for k in range(1, 64)
    ]


@given(seq=st.text(alphabet="ACGTN", min_size=1, max_size=60))
@settings(max_examples=50, deadline=None)
def test_dna_encode_decode_equal(seq):
    got = dna.encode_seq(seq, mask_invalid=True)
    assert np.array_equal(got, jax_dna.encode_seq(seq, mask_invalid=True))
    assert dna.decode_seq(got) == jax_dna.decode_seq(got)
    assert dna.has_ambiguous(got) == jax_dna.has_ambiguous(got)


@given(seq=dna_strings)
@settings(max_examples=50, deadline=None)
def test_dna_strand_and_rotation_equal(seq):
    assert dna.revcomp_str(seq) == jax_dna.revcomp_str(seq)
    assert dna.canonical_str(seq) == jax_dna.canonical_str(seq)
    assert dna.least_rotation(seq) == jax_dna.least_rotation(seq)
    assert dna.canonical_cycle(seq) == jax_dna.canonical_cycle(seq)
    codes = dna.encode_seq(seq)
    assert np.array_equal(dna.revcomp_codes(codes),
                          jax_dna.revcomp_codes(codes))
    if len(seq) <= 63:
        words = dna.kmer_to_words(codes)
        assert words == jax_dna.kmer_to_words(codes)
        assert dna.words_to_kmer(words, len(seq)) == jax_dna.words_to_kmer(
            words, len(seq)) == seq


def test_dna_least_rotation_long_input_equal():
    # past the vectorized path's threshold, periodic and not
    rng = np.random.default_rng(5)
    for s in ("ACGT" * 700, dna.decode_seq(rng.integers(0, 4, 3000))):
        assert dna.least_rotation(s) == jax_dna.least_rotation(s)
        assert dna.canonical_cycle(s) == jax_dna.canonical_cycle(s)


@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (5, 100), (4, 101),
                                   (2, 250), (6, 33)])
def test_dna_pack_unpack_byte_equal(shape):
    rng = np.random.default_rng(sum(shape))
    reads = rng.integers(0, 4, size=shape, dtype=np.uint8)
    assert dna.pack_invalid_mask(reads) is None
    assert jax_dna.pack_invalid_mask(reads) is None
    reads[rng.random(shape) < 0.1] = dna.INVALID_CODE
    reads[0, 0] = dna.INVALID_CODE
    packed = dna.pack_codes(reads)
    want = jax_dna.pack_codes(reads)
    assert packed.dtype == want.dtype and np.array_equal(packed, want)
    inv, inv_want = dna.pack_invalid_mask(reads), jax_dna.pack_invalid_mask(reads)
    assert inv.dtype == inv_want.dtype and np.array_equal(inv, inv_want)
    n = shape[0] * shape[1]
    flat = dna.pack_codes((reads & 3).reshape(1, -1))[0]
    assert np.array_equal(dna.unpack_codes_np(flat, n),
                          jax_dna.unpack_codes_np(flat, n))
    assert np.array_equal(dna.unpack_codes_np(flat, n), (reads & 3).ravel())


# ------------------------------------------------------- config and metrics

def test_config_equal():
    for kw in ({}, {"k": 21, "min_count": 0, "read_len": 150},
               {"k": 41, "tip_len": 7, "bubble_len": 9, "batch_reads": 512}):
        a, b = config.AssemblyConfig(**kw), jax_config.AssemblyConfig(**kw)
        assert vars(a) == vars(b)
        assert (a.resolved_tip_len, a.resolved_bubble_len) == (
            b.resolved_tip_len, b.resolved_bubble_len)
    with pytest.raises(ValueError):
        config.AssemblyConfig(k=0)


def test_metrics_class_equal():
    a, b = metrics.Metrics(), jax_metrics.Metrics()
    for m in (a, b):
        with m.stage("count"):
            pass
        m.count("kmers", 70.0)
        m.count("kmers", 30.0)
        m.count("reads", 4.0)
        m.count("hosts", 2.0)
        m.stages["count"] = 0.5  # fixed, so that the derived rates compare
    assert a.counters == b.counters and a.stages == b.stages
    da, db = a.derive(), b.derive()
    assert da == db and da["kmers_per_s"] == 200.0
    ra, rb = a.report(), b.report()
    # the port's report adds its host spans (none here) to the reference's
    assert ra.pop("spans_s") == {}
    assert ra == rb and set(ra) == {"stages_s", "counters", "derived"}


# ------------------------------------------------------------ utils.simulate

@pytest.mark.parametrize("kw", [
    dict(coverage=20, read_len=60, seed=8),
    dict(coverage=30, read_len=100, seed=9, error_rate=0.02, tile_k=31),
    dict(coverage=10, read_len=50, seed=10, both_strands=False),
    dict(coverage=15, read_len=70, seed=11, circular=True, tile_k=41),
    dict(coverage=5, read_len=40, seed=12, tile_exactly=False,
         error_rate=0.1),
], ids=["plain", "errors_tile_k", "single_strand", "circular", "untiled"])
def test_simulate_same_seed_same_reads(kw):
    genome = sim.simulate_genome(3000, seed=kw["seed"] + 100, gc=0.4)
    assert np.array_equal(
        genome, jax_sim.simulate_genome(3000, seed=kw["seed"] + 100, gc=0.4))
    a, b = sim.simulate_reads(genome, **kw), jax_sim.simulate_reads(genome, **kw)
    assert a.codes.dtype == b.codes.dtype and np.array_equal(a.codes, b.codes)
    assert vars(a).keys() == vars(b).keys()
    for name, value in vars(a).items():
        assert np.array_equal(value, getattr(b, name)), name
    assert a.num_reads == b.num_reads


def test_simulate_presets_multi_and_padding_equal():
    assert sim.GENOME_PRESETS == jax_sim.GENOME_PRESETS
    assert np.array_equal(sim.preset_genome("toy10k"),
                          jax_sim.preset_genome("toy10k"))
    lens = [700, 900, 1100]
    ga, gb = (m.simulate_genome_multi(lens, seed=3) for m in (sim, jax_sim))
    assert all(np.array_equal(x, y) for x, y in zip(ga, gb))
    kw = dict(coverage=12, read_len=50, seed=4, error_rate=0.01)
    ra, rb = (m.simulate_reads_multi(ga, **kw) for m in (sim, jax_sim))
    assert np.array_equal(ra.codes, rb.codes)
    pa, na = sim.pad_to_batch(ra.codes, 64)
    pb, nb = jax_sim.pad_to_batch(rb.codes, 64)
    assert na == nb and np.array_equal(pa, pb)


def test_simulate_chip_smoke_seeds_equal():
    # chip_smoke.py holds its contigs against genomes made from these seeds
    for glen, seed, k, err in ((10_000, 1010, 25, 0.0), (48_502, 1020, 31, 0.01)):
        g = sim.simulate_genome(glen, seed=seed)
        assert np.array_equal(g, jax_sim.simulate_genome(glen, seed=seed))
        kw = dict(coverage=3, read_len=100, seed=seed + 1, error_rate=err,
                  tile_k=k)
        assert np.array_equal(sim.simulate_reads(g, **kw).codes,
                              jax_sim.simulate_reads(g, **kw).codes)


# -------------------------------------------------------------- ops.kmer_ref

@pytest.mark.parametrize("k", [2, 15, 16, 21, 31, 32, 41, 63])
def test_kmer_ref_equal(k):
    rng = np.random.default_rng(k)
    reads = rng.integers(0, 4, size=(40, 90), dtype=np.uint8)
    reads[rng.random(reads.shape) < 0.01] = 4
    assert np.array_equal(kmer_ref.window_valid_np(reads, k),
                          jax_kmer_ref.window_valid_np(reads, k))
    assert np.array_equal(kmer_ref.extract_canonical_np(reads, k),
                          jax_kmer_ref.extract_canonical_np(reads, k))
    fa, ra = kmer_ref.extract_kmer_words_np(reads & 3, k)
    fb, rb = jax_kmer_ref.extract_kmer_words_np(reads & 3, k)
    assert np.array_equal(fa, fb) and np.array_equal(ra, rb)
    ua, ca = kmer_ref.count_canonical_np(reads, k)
    ub, cb = jax_kmer_ref.count_canonical_np(reads, k)
    assert ua.dtype == ub.dtype and np.array_equal(ua, ub)
    assert ca.dtype == cb.dtype and np.array_equal(ca, cb)


# --------------------------------------------------------------- host stages

# name: (seed, genome_len, coverage, k, error_rate, min_count, circular)
HOST_CASES = {
    "clean": (21, 2500, 30, 21, 0.0, 1, False),
    "errors_tips_bubbles": (22, 3000, 40, 21, 0.02, 1, False),
    "errors_min3": (23, 3000, 60, 25, 0.01, 3, False),
    "circular": (24, 1500, 30, 21, 0.0, 1, True),
    "two_limb": (25, 2000, 30, 41, 0.005, 1, False),
}


def _counts(case):
    seed, glen, cov, k, err, mc, circ = HOST_CASES[case]
    reads, genome = _reads(seed, glen, cov, 80, k, err, circular=circ)
    counts = jax_oracle.count_canonical_fast(reads, k)
    return {km: c for km, c in counts.items() if c >= mc}, k, mc, genome


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_dbg_compress_equal(case):
    counts, k, _, _ = _counts(case)
    ea, eb = dbg.both_strand_edges(counts), jax_dbg.both_strand_edges(counts)
    assert ea == eb
    ua, ub = dbg.compress_unitigs(ea, k), jax_dbg.compress_unitigs(eb, k)
    assert [vars(u) for u in ua] == [vars(u) for u in ub]
    assert _graph_view(dbg.unitig_graph_from_counts(counts, k)) == _graph_view(
        jax_dbg.unitig_graph_from_counts(counts, k))
    assert [dbg.unitig_kmers(u) for u in ua[:20]] == [
        jax_dbg.unitig_kmers(u) for u in ub[:20]]


def test_dbg_words_to_strings_equal():
    reads, _ = _reads(31, 1500, 20, 80, 41)
    uniq, cnt = jax_kmer_ref.count_canonical_np(reads, 41)
    assert dbg.words_to_strings(uniq, 41) == jax_dbg.words_to_strings(uniq, 41)
    assert dbg.counts_to_dict(uniq, cnt, 41) == jax_dbg.counts_to_dict(
        uniq, cnt, 41)


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_simplify_counts_equal(case):
    counts, k, mc, _ = _counts(case)
    tip, bub = 2 * k, 2 * k + 2
    ga = simplify.simplify_counts(counts, k, tip, bub, mc)
    gb = jax_simplify.simplify_counts(counts, k, tip, bub, mc)
    assert _graph_view(ga) == _graph_view(gb)
    if "errors" in case:
        # the error-bearing graphs really are simplified, not passed through
        raw = jax_dbg.unitig_graph_from_counts(counts, k)
        assert len(gb.unitigs) < len(raw.unitigs)


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_simplify_arrays_to_graph_equal(case):
    counts, k, mc, _ = _counts(case)
    unitigs = jax_dbg.compress_unitigs(jax_dbg.both_strand_edges(counts), k)
    tip, bub = 2 * k, 2 * k + 2
    ua = sa.from_unitigs([dbg.Unitig(**vars(u)) for u in unitigs], k)
    ub = jax_sa.from_unitigs(unitigs, k)
    for field in vars(ub):
        assert np.array_equal(getattr(ua, field), getattr(ub, field)), field
    assert [vars(u) for u in sa.to_unitig_list(ua)] == [
        vars(u) for u in jax_sa.to_unitig_list(ub)]
    ga = sa.simplify_arrays_to_graph(ua, tip, bub, mc)
    gb = jax_sa.simplify_arrays_to_graph(ub, tip, bub, mc)
    assert _graph_view(ga) == _graph_view(gb)
    # and the array path agrees with the port's own object path
    assert sorted(u.seq for u in ga.unitigs) == sorted(
        u.seq for u in simplify.simplify_counts(counts, k, tip, bub, mc).unitigs)


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_traverse_equal(case):
    counts, k, mc, genome = _counts(case)
    ga = simplify.simplify_counts(counts, k, 2 * k, 2 * k + 2, mc)
    gb = jax_simplify.simplify_counts(counts, k, 2 * k, 2 * k + 2, mc)
    assert traverse.euler_walks(ga) == jax_traverse.euler_walks(gb)
    for name in ("emit_contigs", "emit_contigs_euler",
                 "emit_contigs_with_cov", "emit_contigs_euler_with_cov"):
        assert getattr(traverse, name)(ga) == getattr(jax_traverse, name)(gb)
    assert traverse.emit_contigs(ga, min_len=100) == jax_traverse.emit_contigs(
        gb, min_len=100)
    contigs = traverse.emit_contigs(ga)
    truth = [dna.decode_seq(genome)]
    for other in (truth, contigs, contigs[:-1] + ["ACGT"],
                  [dna.revcomp_str(c) for c in contigs]):
        assert traverse.contigs_equal(contigs, other) == (
            jax_traverse.contigs_equal(contigs, other))
    assert traverse.canonicalize_contigs(contigs) == (
        jax_traverse.canonicalize_contigs(contigs))
    assert traverse.kmer_content_equal(contigs, truth[0], k) == (
        jax_traverse.kmer_content_equal(contigs, truth[0], k))


def test_traverse_expected_contigs_multi_equal():
    genomes = [dna.decode_seq(g)
               for g in jax_sim.simulate_genome_multi([600, 800], seed=6)]
    for circular in (False, True, [True, False]):
        assert traverse.expected_contigs_multi(genomes, 21, circular) == (
            jax_traverse.expected_contigs_multi(genomes, 21, circular))


@pytest.mark.parametrize("case", ["clean", "errors_tips_bubbles"])
def test_stats_equal(case):
    counts, k, mc, _ = _counts(case)
    ga = simplify.simplify_counts(counts, k, 2 * k, 2 * k + 2, mc)
    gb = jax_simplify.simplify_counts(counts, k, 2 * k, 2 * k + 2, mc)
    contigs = traverse.emit_contigs(ga)
    assert stats.contig_stats(contigs) == jax_stats.contig_stats(contigs)
    assert stats.stats_json(contigs) == jax_stats.stats_json(contigs)
    assert stats.contig_stats([]) == jax_stats.contig_stats([])
    fa, fb = io.StringIO(), io.StringIO()
    stats.write_gfa(ga, fa)
    jax_stats.write_gfa(gb, fb)
    assert fa.getvalue() == fb.getvalue() and fa.getvalue().startswith("H\t")


# ------------------------------------------------------------ models.oracle

# name: (seed, k, error_rate, min_count, n_rate, circular)
ORACLE_CASES = {
    "odd_k": (41, 25, 0.0, 1, 0.0, False),
    "even_k": (42, 24, 0.0, 1, 0.0, False),
    "two_limb_k41": (43, 41, 0.0, 1, 0.0, False),
    "errors_min3": (44, 31, 0.01, 3, 0.0, False),
    "auto_min_count": (45, 31, 0.01, 0, 0.0, False),
    "n_bases": (46, 21, 0.0, 1, 0.003, False),
    "circular": (47, 21, 0.0, 1, 0.0, True),
}


@pytest.mark.parametrize("emit", ["unitigs", "euler"])
@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_assemble_oracle_equal(case, emit):
    seed, k, err, mc, n_rate, circ = ORACLE_CASES[case]
    reads, _ = _reads(seed, 2500, 40, 100, k, err, n_rate, circ)
    ca = config.AssemblyConfig(k=k, min_count=mc, read_len=100)
    cb = jax_config.AssemblyConfig(k=k, min_count=mc, read_len=100)
    got = oracle.assemble_oracle(reads, ca, emit=emit)
    assert got == jax_oracle.assemble_oracle(reads, cb, emit=emit)
    assert got


def test_oracle_dict_counting_equal():
    reads, _ = _reads(48, 800, 15, 60, 21, n_rate=0.01)
    want = jax_oracle.count_canonical_dict(reads, 21)
    assert oracle.count_canonical_dict(reads, 21) == want
    assert oracle.count_canonical_fast(reads, 21) == want
    strings = [dna.decode_seq(r) for r in reads[:50]] + ["ACGTNACGT", "AC"]
    cfg = config.AssemblyConfig(k=21, read_len=60)
    assert oracle.assemble_oracle(strings, cfg) == jax_oracle.assemble_oracle(
        strings, jax_config.AssemblyConfig(k=21, read_len=60))


@pytest.mark.parametrize("case", ["errors", "clean", "empty", "flat", "capped"])
def test_auto_min_count_counts_branch_equal(case):
    rng = np.random.default_rng(3)
    counts = {
        "errors": np.concatenate([np.ones(4000, np.int64),
                                  np.full(300, 2), rng.poisson(40, 5000)]),
        "clean": rng.poisson(30, 3000) + 5,
        "empty": np.empty(0, np.int64),
        "flat": np.array([1, 1, 2, 2, 3]),
        "capped": np.concatenate([np.ones(500, np.int64),
                                  rng.poisson(1500, 2000)]),
    }[case]
    want = jax_pipeline.auto_min_count(counts)
    assert pipeline.auto_min_count(counts) == want
    assert pipeline.auto_min_count(list(counts)) == want
    if case == "errors":
        assert want > 1


# ------------------------------------------------------- CLI helpers and I/O

FORMATS = {
    "lines": "ACGTACGTAC\nTTGACCAGTA\nGGCATNACGT\n",
    "lines_lower_blank": "acgtacgtac\n\nTTGACCAGTA\n",
    "fasta": ">r0\nACGTACGTAC\n>r1 extra\nTTGAC\nCAGTA\n",
    "fastq": "@r0\nACGTACGTAC\n+\nIIIIIIIIII\n@r1\nTTGACCAGTA\n+\nIIIIIIIIII\n",
    "ragged": "ACGTACGTAC\nTTGAC\n",
    "empty": "",
}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_read_sequences_and_native_loader_equal(tmp_path, fmt):
    path = tmp_path / "reads.txt"
    path.write_text(FORMATS[fmt])
    seqs = cli.read_sequences(str(path))
    assert seqs == jax_cli.read_sequences(str(path))
    got, want = io_native.load_reads(str(path)), jax_io.load_reads(str(path))
    assert (got is None) == (want is None)
    if got is not None:
        assert got.dtype == want.dtype and np.array_equal(got, want)
        # the native loader against the Python parser
        assert np.array_equal(got, np.stack(
            [dna.encode_seq(s, mask_invalid=True) for s in seqs]))
    if fmt not in ("empty",):
        assert np.array_equal(cli._load_reads(str(path))[0, :5],
                              dna.encode_seq(seqs[0][:5], mask_invalid=True))


def test_malformed_fastq_raises_in_both(tmp_path):
    path = tmp_path / "bad.fq"
    path.write_text("@r0\nACGT\n+\n")
    for module in (cli, jax_cli):
        with pytest.raises(ValueError, match="malformed FASTQ"):
            module.read_sequences(str(path))


def test_native_library_builds_from_the_ports_own_source():
    assert io_native.available() == jax_io.available()
    assert "genome_assembler_tpu_torch" in io_native._NATIVE_DIR
    codes = np.array([0, 1, 2, 3, 3, 0], dtype=np.uint8)
    assert io_native.decode_seq_native(codes) == jax_io.decode_seq_native(codes)


@pytest.mark.parametrize("coverages", [None, [12.34, 5.0]])
def test_write_fasta_round_trip(tmp_path, coverages):
    contigs = ["ACGT" * 50, "TTGACCAGTA"]
    fa, fb = io.StringIO(), io.StringIO()
    cli.write_fasta(contigs, fa, coverages=coverages)
    jax_cli.write_fasta(contigs, fb, coverages=coverages)
    assert fa.getvalue() == fb.getvalue()
    path = tmp_path / "c.fa"
    path.write_text(fa.getvalue())
    assert cli.read_sequences(str(path)) == contigs


@pytest.mark.parametrize("argv", [
    ["--preset", "toy10k", "--coverage", "5"],
    ["--genome-len", "3000", "--coverage", "8", "--error-rate", "0.01",
     "--read-seed", "7", "--single-strand"],
    ["--genome-len", "3000", "--chromosomes", "3", "--coverage", "6",
     "--circular", "--read-len", "60"],
], ids=["preset", "genome_len", "multi_circular"])
def test_simulated_reads_equal(argv):
    import argparse

    out = []
    for module in (cli, jax_cli):
        p = argparse.ArgumentParser()
        module._add_sim_args(p)
        codes, genomes = module._simulated_reads(p.parse_args(argv))
        out.append((codes, genomes))
    assert np.array_equal(out[0][0], out[1][0])
    assert len(out[0][1]) == len(out[1][1])
    assert all(np.array_equal(x, y) for x, y in zip(out[0][1], out[1][1]))
