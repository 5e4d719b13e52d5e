"""The port's extraction (plain torch version on the CPU) vs the JAX package:
the XLA twin ``kmer_jax.extract_canonical_flat``, the Pallas kernel in
interpret mode, and the NumPy reference ``kmer_ref``. Exact: integer work,
every comparison is bit-equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from genome_assembler_tpu.ops import kmer_ref
from genome_assembler_tpu.ops.kmer_jax import (
    extract_canonical_flat as extract_jax,
    unpack_invalid_mask as unpack_invalid_jax,
)
from genome_assembler_tpu.ops.kmer_pallas import extract_canonical_flat_pallas
from genome_assembler_tpu.utils.dna import pack_codes, pack_invalid_mask
from genome_assembler_tpu_torch.ops import kmer_torch
from genome_assembler_tpu_torch.utils.keys import SENTINEL, limbs_to_words

# xdist workers share the cores: one intra-op thread each keeps the plain
# versions' many small CPU ops from oversubscribing them
torch.set_num_threads(1)

KS = [21, 25, 31, 41, 63]


def _reads(seed, b, length, n_rate=0.0):
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, size=(b, length), dtype=np.uint8)
    if n_rate:
        reads[rng.random(reads.shape) < n_rate] = 4
    return reads


def _packed(reads):
    inv = pack_invalid_mask(reads)
    return (
        torch.from_numpy(pack_codes(reads)),
        None if inv is None else torch.from_numpy(inv),
    )


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n_rate", [0.0, 0.02])
def test_packed_and_raw_match_xla(k, n_rate):
    """B=300 (not a multiple of 256), n_valid=250; Ns both as raw code 4
    (raw input) and through the packed invalid plane (packed input)."""
    reads = _reads(k, 300, 100, n_rate)
    n_valid = 250
    want_raw, _ = extract_jax(jnp.asarray(reads), k, np.int32(n_valid))
    want_raw = np.asarray(want_raw)
    packed, inv = _packed(reads)
    got = kmer_torch.extract_canonical_flat(packed, 100, k, n_valid, inv)
    np.testing.assert_array_equal(limbs_to_words(got.numpy(), k), want_raw)
    got_raw = kmer_torch.extract_canonical_codes_ref(
        torch.from_numpy(reads), k, n_valid
    )
    np.testing.assert_array_equal(limbs_to_words(got_raw.numpy(), k), want_raw)
    wc = 100 - k + 1
    assert (got[n_valid * wc :] == SENTINEL).all()


@pytest.mark.parametrize("k", KS)
def test_matches_pallas_interpret(k):
    """The TPU kernel itself, run as tests/test_kmer_pallas.py runs it."""
    reads = _reads(100 + k, 256, 70, 0.02)
    n_valid = 200
    bad = reads > 3
    with pltpu.force_tpu_interpret_mode():
        want, _ = extract_canonical_flat_pallas(
            jnp.asarray(reads), k, np.int32(n_valid), bad=jnp.asarray(bad)
        )
    packed, inv = _packed(reads)
    got = kmer_torch.extract_canonical_flat(packed, 70, k, n_valid, inv)
    np.testing.assert_array_equal(limbs_to_words(got.numpy(), k), np.asarray(want))


@pytest.mark.parametrize("k", KS)
def test_matches_numpy_reference(k):
    reads = _reads(200 + k, 37, 90, 0.01)
    want = kmer_ref.extract_canonical_np(reads, k)
    want[~kmer_ref.window_valid_np(reads, k)] = 0xFFFFFFFF
    packed, inv = _packed(reads)
    got = kmer_torch.extract_canonical_flat(packed, 90, k, inv_bits=inv)
    np.testing.assert_array_equal(limbs_to_words(got.numpy(), k), want)


def test_unpack_matches_jax():
    reads = _reads(7, 9, 43, 0.1)
    packed, inv = _packed(reads)
    np.testing.assert_array_equal(
        kmer_torch.unpack_codes(packed, 43).numpy(), reads & 3
    )
    np.testing.assert_array_equal(
        kmer_torch.unpack_invalid_mask(inv, 43).numpy(),
        np.asarray(unpack_invalid_jax(jnp.asarray(inv.numpy()), 43)),
    )


def test_wrapper_checks_and_cpu_path_launches_nothing():
    reads = _reads(8, 5, 40)
    packed, _ = _packed(reads)
    before = kmer_torch.extract_canonical_flat.launches
    kmer_torch.extract_canonical_flat(packed, 40, 21)
    assert kmer_torch.extract_canonical_flat.launches == before
    with pytest.raises(ValueError, match="uint8"):
        kmer_torch.extract_canonical_flat(packed.to(torch.int32), 40, 21)
    with pytest.raises(ValueError, match="bytes per read"):
        kmer_torch.extract_canonical_flat(packed, 44, 21)
    with pytest.raises(ValueError, match="n_valid"):
        kmer_torch.extract_canonical_flat(packed, 40, 21, n_valid=6)
    with pytest.raises(ValueError, match="invalid bits"):
        kmer_torch.extract_canonical_flat(
            packed, 40, 21, inv_bits=torch.zeros((5, 9), dtype=torch.uint8)
        )
    with pytest.raises(ValueError, match="k must be"):
        kmer_torch.extract_canonical_flat(packed, 40, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        kmer_torch.extract_canonical_flat(packed.to("meta"), 40, 21)


@pytest.mark.parametrize("read_len,k", [
    (100, 31), (100, 21), (100, 41), (100, 63), (250, 21), (31, 31), (2, 2),
    (101, 32), (4000, 31), (140_000, 31), (300_000, 63),
])
def test_launch_plan_geometry(read_len, k):
    """The kernel's block layout (computed on the host, checked again by
    the kernel's entry point): an even number of whole reads, shared spans
    that hold the rows, their misalignment and the funnel shifts' reach."""
    plan = kmer_torch.launch_plan(read_len, k)
    wc = read_len - k + 1
    r = plan.reads_per_block
    assert r % 2 == 0 and 2 <= r <= kmer_torch.MAX_READS_PER_BLOCK
    assert plan.code_words >= -(-r * ((read_len + 3) // 4) // 4) + 1 + 4
    assert plan.inv_words >= -(-r * ((read_len + 7) // 8) // 4) + 1 + 2
    assert plan.shared_bytes == 4 * (plan.code_words + plan.inv_words)
    assert plan.shared_bytes <= kmer_torch.SHARED_MAX
    if plan.shared_bytes > kmer_torch.SHARED_DEFAULT:
        assert r == 2  # more shared memory is asked for only as a last resort
    if 2 < r < kmer_torch.MAX_READS_PER_BLOCK and plan.shared_bytes < 40_000:
        assert kmer_torch.BLOCK_WINDOWS <= r * wc < kmer_torch.BLOCK_WINDOWS + 2 * wc
    assert r * wc < 2**30  # the kernel indexes a block's windows in 32 bits


def test_launch_plan_refuses_rows_that_do_not_fit_a_block():
    with pytest.raises(ValueError, match="shared memory"):
        kmer_torch.launch_plan(400_000, 31)
    # the refusal is the plan's, whatever the device: a CPU tensor still
    # goes through the plain version, which has no such limit
    assert kmer_torch.launch_plan(100, 31).reads_per_block == 60


@pytest.mark.parametrize(
    "shape, want",
    [
        # the main batch: 262,144 reads x 100 bp, k=31, no invalid bits
        ((262_144, 100, 31, False), (146_800_640 + 6_553_600, "bytes")),
        # invalid bits add ceil(L/8) bytes a read; two limbs at k=41
        ((1000, 100, 41, True), (1000 * 60 * 16 + 1000 * 25 + 1000 * 13,
                                 "bytes")),
    ],
    ids=["main_batch", "two_limbs_with_bits"],
)
def test_kernel_bound(shape, want):
    """The extraction's bound: every input byte read once, every key limb
    written once, over the H100's 3.35 TB/s (the larger bound here)."""
    ms, by, nbytes = kmer_torch.kernel_bound_ms(*shape)
    assert (nbytes, by) == want
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    b, length, k, _ = shape
    ops = (b * (length - k + 1) * (1 if k <= 31 else 2)
           * kmer_torch.OPS_PER_WINDOW_LIMB)
    ops_ms = ops / kmer_torch.INT_OPS_PER_S * 1e3
    assert ops_ms < ms
