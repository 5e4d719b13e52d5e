"""The port's minimizer super-k-mers (``ops/superkmer_torch.py``) against
the reference (``ops/superkmer.py``) on the same codes, and the routing
invariants: records reproduce the window-key multiset (Ns included), and
every occurrence of a canonical k-mer gets one owner. Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_assembler_tpu.ops import superkmer as ref_sk
from genome_assembler_tpu.ops.kmer_ref import window_valid_np
from genome_assembler_tpu.utils.dna import INVALID_CODE
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads
from genome_assembler_tpu_torch.ops import superkmer_torch as sk
from genome_assembler_tpu_torch.ops.kmer_torch import extract_canonical_codes_ref
from genome_assembler_tpu_torch.utils.keys import SENTINEL, limbs_to_words

torch.set_num_threads(1)


def _codes(seed, genome_len=1200, coverage=8, read_len=80, n_rate=0.0):
    genome = simulate_genome(genome_len, seed=seed)
    codes = simulate_reads(genome, coverage=coverage, read_len=read_len,
                           seed=seed + 1).codes.copy()
    if n_rate:
        rng = np.random.default_rng(seed + 2)
        codes[rng.random(codes.shape) < n_rate] = INVALID_CODE
    return codes


def _records(codes, k, m):
    """The port's records of [B, L] codes (Ns masked as in the pipeline)."""
    clean = torch.from_numpy(codes & np.uint8(3))
    wv = torch.from_numpy(window_valid_np(codes, k).reshape(codes.shape[0], -1))
    hmin, mpos = sk.window_minimizers(clean, k, m)
    brk, run, sub, _ = sk.superkmer_records(clean, k, hmin, mpos, wv)
    return hmin, mpos, brk, run, sub, wv


@pytest.mark.parametrize("k,m", [(21, 11), (31, 15), (41, 15), (63, 16)])
def test_port_equals_reference(k, m):
    codes = _codes(k, n_rate=0.01)
    hmin, mpos, brk, run, sub, wv = _records(codes, k, m)
    clean = jnp.asarray(codes & np.uint8(3))
    r_hmin, r_mpos = ref_sk.window_minimizers(clean, k, m)
    r_brk, r_run, r_sub, _ = ref_sk.superkmer_records(
        clean, k, r_hmin, r_mpos, jnp.asarray(wv.numpy())
    )
    np.testing.assert_array_equal(hmin.numpy(), np.asarray(r_hmin))
    np.testing.assert_array_equal(mpos.numpy(), np.asarray(r_mpos))
    np.testing.assert_array_equal(brk.numpy(), np.asarray(r_brk))
    np.testing.assert_array_equal(run.numpy(), np.asarray(r_run))
    np.testing.assert_array_equal(sub.numpy(), np.asarray(r_sub))
    # owner side, on the start lanes the routing keeps
    rec_sub, rec_run = sub[brk], run[brk]
    keys, valid = sk.extract_from_records(rec_sub, rec_run, k)
    r_keys, r_valid = ref_sk.extract_from_records(
        jnp.asarray(rec_sub.numpy().astype(np.uint32)),
        jnp.asarray(rec_run.numpy().astype(np.int32)), k,
    )
    np.testing.assert_array_equal(valid.numpy(), np.asarray(r_valid))
    np.testing.assert_array_equal(
        limbs_to_words(keys.numpy(), k), np.asarray(r_keys)
    )


@pytest.mark.parametrize(
    "k,m,n_rate", [(21, 11, 0.0), (31, 15, 0.0), (31, 15, 0.02), (25, 16, 0.02)]
)
def test_records_reproduce_window_multiset(k, m, n_rate):
    codes = _codes(100 + k, n_rate=n_rate)
    _, _, brk, run, sub, wv = _records(codes, k, m)
    rec_run = run[brk]
    assert bool(((rec_run >= 1) & (rec_run <= sk.RUN_CAP)).all())
    assert int(rec_run.sum()) == int(wv.sum())  # each window exactly once
    keys, valid = sk.extract_from_records(sub[brk], rec_run, k)
    got = np.sort(keys[valid].numpy(), axis=0)
    want = extract_canonical_codes_ref(torch.from_numpy(codes), k)
    want = want[want[:, 0] != SENTINEL].numpy()
    np.testing.assert_array_equal(got, np.sort(want, axis=0))


def test_same_kmer_same_owner():
    codes = _codes(25, genome_len=600, coverage=10, read_len=70)
    k, m = 21, 11
    hmin, _ = sk.window_minimizers(torch.from_numpy(codes), k, m)
    keys = extract_canonical_codes_ref(torch.from_numpy(codes), k)[:, 0]
    owner = {}
    for key, h in zip(keys.tolist(), hmin.reshape(-1).tolist()):
        assert owner.setdefault(key, h) == h, "k-mer routed to two owners"


def test_wire_columns_are_32_bit():
    """A record crosses the wire as span_words + 1 int32 columns: the bit
    patterns survive the round trip, including words >= 2^31."""
    x = torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF])
    bits = sk.to_int32_bits(x)
    assert bits.dtype == torch.int32
    assert torch.equal(sk.from_int32_bits(bits), x)
    assert [sk.span_words(k) for k in (15, 31, 47, 63)] == [
        ref_sk.span_words(k) for k in (15, 31, 47, 63)
    ]
    assert sk.mean_run(31, 15) == ref_sk.mean_run(31, 15)
