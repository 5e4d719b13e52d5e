"""The read generator against the statistics of the port's simulator:
the read count, reads that are substrings of one strand or the other
and of one chromosome, tiling that leaves no k-mer out, strands about
even, repeats where the configuration puts them, and the same reads from
the same seed."""

import numpy as np
import pytest
import torch

from harness import generate

CONFIG = {"chromosomes": [30_000], "gc": 0.5, "assembly": {"k": 31}}
TRAFFIC = {"coverage": 20, "read_len": 100, "error_rate": 0.0,
           "n_rate": 0.0}
SEED = 2**33 + 11  # wider than 32 bits: seeds may be


def _genome(config, seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return generate.make_genome(config, gen, "cpu")[0].numpy()


def test_counts_and_determinism():
    reads = generate.make_reads(CONFIG, TRAFFIC, SEED, "cpu")
    # ceil(20 x 30,000 / 100), as utils/simulate.py counts them
    assert reads.shape == (6000, 100) and reads.dtype == np.uint8
    assert reads.max() <= 3
    again = generate.make_reads(CONFIG, TRAFFIC, SEED, "cpu")
    assert np.array_equal(reads, again)
    other = generate.make_reads(CONFIG, TRAFFIC, SEED + 1, "cpu")
    assert not np.array_equal(reads, other)
    assert generate.read_count(4_641_652, 50, 100) == 2_320_826
    assert generate.read_count(4_641_652, 200, 100) == 9_283_304
    assert generate.read_count(12_000_000, 100, 100) == 12_000_000


def test_reads_come_from_the_genome_on_both_strands():
    reads = generate.make_reads(CONFIG, TRAFFIC, SEED, "cpu")
    genome = _genome(CONFIG, SEED)
    fwd = genome.tobytes()
    rev = (3 - genome[::-1]).astype(np.uint8).tobytes()
    on_fwd = sum(fwd.find(r.tobytes()) >= 0 for r in reads[:400])
    on_rev = sum(rev.find(r.tobytes()) >= 0 for r in reads[:400])
    assert on_fwd + on_rev >= 400  # every read lies on a strand
    assert 160 <= on_fwd <= 240  # a fair coin for the strand


def test_tiling_covers_every_kmer_start():
    for k in (21, 31, 41, 99):
        starts = generate.tile_starts(1000, 100, k).numpy()
        assert starts[0] == 0 and starts[-1] == 900
        assert np.diff(starts).max() <= 100 - k + 1


def test_gc_and_uniform_starts():
    genome = _genome(dict(CONFIG, chromosomes=[200_000], gc=0.6), 5)
    gc = np.isin(genome, (1, 2)).mean()
    assert gc == pytest.approx(0.6, abs=0.01)
    assert np.bincount(genome, minlength=4).min() > 0.18 * len(genome)


def test_errors_and_n_bases():
    traffic = dict(TRAFFIC, error_rate=0.01, n_rate=0.001)
    reads = generate.make_reads(CONFIG, traffic, SEED, "cpu")
    clean = generate.make_reads(CONFIG, TRAFFIC, SEED, "cpu")
    assert reads.shape == clean.shape
    n_share = (reads == generate.N_CODE).mean()
    assert n_share == pytest.approx(0.001, rel=0.3)
    with pytest.raises(ValueError):
        generate.make_reads(CONFIG, TRAFFIC, -1, "cpu")


def test_chromosomes_each_at_the_coverage():
    config = dict(CONFIG, chromosomes=[9_000, 300, 20_700])
    reads = generate.make_reads(config, TRAFFIC, SEED, "cpu")
    # ceil(20 x length / 100) a chromosome: 1,800 + 60 + 4,140
    assert reads.shape == (6000, 100)
    genome = _genome(config, SEED)
    chroms = [genome[:9_000], genome[9_000: 9_300], genome[9_300:]]
    strands = [c.tobytes() for c in chroms]
    strands += [(3 - c[::-1]).astype(np.uint8).tobytes() for c in chroms]
    hits = np.zeros(3, dtype=int)
    for r in reads[:600]:
        where = [i % 3 for i, s in enumerate(strands) if s.find(r.tobytes()) >= 0]
        assert where  # no read spans two chromosomes
        hits[where[0]] += 1
    assert 140 <= hits[0] <= 220 and hits[1] <= 20 and hits[2] >= 340


def test_repeats_where_the_configuration_puts_them():
    fam = {"name": "r", "length": 500, "copies": 4, "reverse": 1}
    config = dict(CONFIG, chromosomes=[10_000, 10_000], repeats=[fam])
    genome = _genome(config, SEED)
    at = generate.repeat_starts(20_000, 500, 4)
    assert at == [2250, 7250, 12250, 17250]
    copies = [genome[a: a + 500] for a in at]
    for c in copies[1:3]:
        assert np.array_equal(c, copies[0])
    assert np.array_equal(copies[3], (3 - copies[0][::-1]).astype(np.uint8))
    with pytest.raises(ValueError):  # a copy across two chromosomes
        _genome(dict(config, chromosomes=[12_400, 7_600]), SEED)

