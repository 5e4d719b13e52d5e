"""The port's counting (ops.count_torch) vs count_jax on the same keys.
Exact: keys, counts, num_unique and overflow bit for bit; padding rows
are sentinel keys with count 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_assembler_tpu.models.pipeline import auto_min_count as auto_jax
from genome_assembler_tpu.ops import count_jax, kmer_ref
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads
from genome_assembler_tpu_torch.models.pipeline import auto_min_count
from genome_assembler_tpu_torch.ops import count_torch
from genome_assembler_tpu_torch.utils.keys import words_to_limbs

# xdist workers share the cores: one intra-op thread each keeps the plain
# versions' many small CPU ops from oversubscribing them
torch.set_num_threads(1)


def _keys(seed, k, error_rate=0.0, reads=120):
    genome = simulate_genome(1500, seed=seed)
    rs = simulate_reads(genome, coverage=reads * 80 / 1500, read_len=80,
                        seed=seed + 1, error_rate=error_rate)
    words = kmer_ref.extract_canonical_np(rs.codes, k)
    # sprinkle invalid (sentinel) windows
    words[np.random.default_rng(seed).random(len(words)) < 0.05] = 0xFFFFFFFF
    return words


def _port(words):
    return torch.from_numpy(words_to_limbs(words))


def assert_tables_equal(got, want, k):
    words, counts, num, over = count_torch.count_table_to_numpy(got, k)
    want_words = np.asarray(want.words)
    assert int(num) == int(want.num_unique)
    assert bool(over) == bool(want.overflow)
    assert words.shape == want_words.shape
    np.testing.assert_array_equal(words[: int(num)], want_words[: int(num)])
    np.testing.assert_array_equal(counts, np.asarray(want.counts))
    assert (words[int(num):] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("k", [25, 41])
def test_count_keys(k):
    words = _keys(1, k)
    want = count_jax.count_keys(jnp.asarray(words))
    assert_tables_equal(count_torch.count_keys(_port(words)), want, k)


@pytest.mark.parametrize("k", [21, 63])
def test_count_keys_weighted(k):
    words = _keys(2, k)
    w = np.random.default_rng(3).integers(1, 9, size=len(words)).astype(np.int32)
    want = count_jax.count_keys(jnp.asarray(words), jnp.asarray(w))
    got = count_torch.count_keys(_port(words), torch.from_numpy(w))
    assert_tables_equal(got, want, k)


@pytest.mark.parametrize("k,cap", [(25, 16384), (41, 16384), (25, 700)])
def test_merge_raw_keys_stream(k, cap):
    """A multi-batch stream: every batch merges raw keys into the running
    table; cap=700 overflows and must say so."""
    words = _keys(4, k, error_rate=0.01, reads=400)
    batches = np.array_split(words, 4)
    # the reference's table after batch 1 is a merge into an empty table;
    # the port takes the first-batch fast path (count, then pad/truncate)
    jt = count_jax.merge_raw_keys(
        count_jax.empty_table(cap, words.shape[1]), jnp.asarray(batches[0])
    )
    pt = count_torch.resize_table(count_torch.count_keys(_port(batches[0])), cap)
    assert_tables_equal(pt, jt, k)
    for batch in batches[1:]:
        jt = count_jax.merge_raw_keys(jt, jnp.asarray(batch))
        pt = count_torch.merge_raw_keys(pt, _port(batch))
        assert_tables_equal(pt, jt, k)
    assert bool(pt.overflow) == (cap == 700)


@pytest.mark.parametrize("min_count", [1, 3])
def test_filter_and_compact(min_count):
    k = 31
    words = _keys(5, k, error_rate=0.02, reads=300)
    jt = count_jax.count_keys(jnp.asarray(words))
    pt = count_torch.count_keys(_port(words))
    jt = count_jax.compact_table(count_jax.filter_table(jt, min_count))
    pt = count_torch.compact_table(count_torch.filter_table(pt, min_count))
    assert_tables_equal(pt, jt, k)


def test_histogram_and_auto_min_count():
    k = 25
    genome = simulate_genome(3000, seed=6)
    rs = simulate_reads(genome, coverage=40, read_len=80, seed=7,
                        error_rate=0.01)
    words = kmer_ref.extract_canonical_np(rs.codes, k)
    jt = count_jax.count_keys(jnp.asarray(words))
    pt = count_torch.count_keys(_port(words))
    np.testing.assert_array_equal(
        count_torch.multiplicity_histogram(pt).numpy(),
        np.asarray(count_jax.multiplicity_histogram(jt)),
    )
    mc = auto_min_count(pt)
    assert mc == auto_jax(jt) and mc > 1  # a real valley
    counts = np.asarray(jt.counts)[: int(jt.num_unique)]
    assert auto_jax(counts) == mc  # the oracle's host-counts route
    # no valley (all counts 1) and empty tables pick 1
    ones = count_torch.count_keys(torch.arange(10, dtype=torch.int64)[:, None])
    assert auto_min_count(ones) == 1
    empty = count_torch.empty_table(16, 1, "cpu")
    assert auto_min_count(empty) == 1


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("cols", [1, 2, 3, 4])
def test_take_rows_equals_indexing(cols, dtype):
    rng = np.random.default_rng(cols)
    x = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, (500, cols))).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 500, 1200))
    got = count_torch.take_rows(x, idx)
    assert got.dtype == dtype and torch.equal(got, x[idx])
    assert torch.equal(count_torch.take_rows(x[:, 0], idx), x[idx, 0])


def test_numpy_bridge_round_trip():
    k = 41
    jt = count_jax.count_keys(jnp.asarray(_keys(8, k)))
    pt = count_torch.count_table_from_numpy(
        np.asarray(jt.words), np.asarray(jt.counts),
        np.asarray(jt.num_unique), np.asarray(jt.overflow),
    )
    assert_tables_equal(pt, jt, k)
