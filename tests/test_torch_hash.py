"""The port's routing hash (``ops/hash_torch.py``) against the reference's
NumPy ``mix_words``/``mix32`` on the same keys: exact equality."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from genome_assembler_tpu.ops.hash import mix32 as ref_mix32
from genome_assembler_tpu.ops.hash import mix_words as ref_mix_words
from genome_assembler_tpu.utils.dna import key_words
from genome_assembler_tpu_torch.ops import hash_torch
from genome_assembler_tpu_torch.utils.keys import words_to_limbs

torch.set_num_threads(1)


def _random_key_words(rng, n, k):
    """[n, key_words(k)] uint32 words of random 2k-bit keys, with the
    smallest and largest key included."""
    w = key_words(k)
    words = rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64)
    words = words.astype(np.uint32)
    top_bits = 2 * k - 32 * (w - 1)
    words[:, 0] &= np.uint32((1 << top_bits) - 1)
    words[0] = 0
    words[1] = 0xFFFFFFFF
    words[1, 0] = (1 << top_bits) - 1
    return words


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), k=st.sampled_from([15, 21, 31, 41, 63]))
def test_hash_equals_reference(seed, k):
    rng = np.random.default_rng(seed)
    words = _random_key_words(rng, 257, k)
    limbs = torch.from_numpy(words_to_limbs(words))
    got_words = hash_torch.limbs_to_key_words(limbs, k)
    np.testing.assert_array_equal(got_words.numpy(), words.astype(np.int64))
    want = ref_mix_words(words).astype(np.int64)
    got = hash_torch.mix_words(got_words)
    np.testing.assert_array_equal(got.numpy(), want)
    for d in (2, 3, 4, 8):
        np.testing.assert_array_equal(
            hash_torch.owner_of(limbs, k, d).numpy(), want % d
        )


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**32 - 1))
def test_mix32_and_mul32_cover_the_full_uint32_range(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, size=1000, dtype=np.uint64).astype(np.uint32)
    x[:3] = [0, 0x7FFFFFFF, 0xFFFFFFFF]
    xt = torch.from_numpy(x.astype(np.int64))
    np.testing.assert_array_equal(
        hash_torch.mix32(xt).numpy(), ref_mix32(x).astype(np.int64)
    )
    b = int(rng.integers(0, 1 << 32))
    want = (x.astype(np.uint64) * np.uint64(b)) & np.uint64(0xFFFFFFFF)
    np.testing.assert_array_equal(
        hash_torch.mul32(xt, b).numpy(), want.astype(np.int64)
    )


@pytest.mark.parametrize("k", [15, 31, 41, 63])
def test_owner_spread_is_balanced(k):
    """Routing balance: 4 owners of 20,000 random keys each get 25% +- 2%."""
    words = _random_key_words(np.random.default_rng(k), 20_000, k)
    owners = hash_torch.owner_of(torch.from_numpy(words_to_limbs(words)), k, 4)
    share = torch.bincount(owners, minlength=4).double() / owners.numel()
    assert torch.all((share - 0.25).abs() < 0.02), share
