"""The port's packed mask codec (``repro_torch.core.bitmask``) against the
JAX package's (``repro.core.bitmask``): words bitwise JAX's ``pack_bits``,
round trips exact, pad bits 0, per-shard packing equal to the whole
mask's, and ``all_gather_bits`` over 2 gloo ranks equal to a bool
gather."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import bitmask as jbits
from repro_torch.core import bitmask as tbits
from repro_torch.launch.mesh import spawn_ranks

import torch_dist_workers as workers


def _words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 100, 257])
def test_pack_unpack_round_trip_and_words_bitwise_jax(n):
    mask = np.random.default_rng(n).random(n) < 0.5
    words = tbits.pack_bits(torch.from_numpy(mask))
    assert tuple(words.shape) == (tbits.n_words(n),) == (jbits.n_words(n),)
    assert words.dtype == torch.int32
    want = np.asarray(jbits.pack_bits(jnp.asarray(mask)))
    assert _words(words).tobytes() == want.tobytes()
    np.testing.assert_array_equal(tbits.unpack_bits(words, n).numpy(), mask)
    np.testing.assert_array_equal(tbits.unpack_bits_np(words.numpy(), n),
                                  mask)
    np.testing.assert_array_equal(tbits.unpack_bits_np(want, n), mask)


def test_leading_batch_dims_bitwise_jax():
    mask = np.random.default_rng(0).random((4, 5, 100)) < 0.3
    words = tbits.pack_bits(torch.from_numpy(mask))
    assert tuple(words.shape) == (4, 5, tbits.n_words(100))
    assert _words(words).tobytes() == np.asarray(
        jbits.pack_bits(jnp.asarray(mask))).tobytes()
    np.testing.assert_array_equal(tbits.unpack_bits(words, 100).numpy(),
                                  mask)


def test_pad_bits_zero_and_little_endian():
    words = _words(tbits.pack_bits(torch.ones(33, dtype=torch.bool)))
    assert words[1] == 1                          # only bit 0 of word 1
    assert not tbits.unpack_bits(torch.from_numpy(words.view(np.int32)),
                                 40).numpy()[33:].any()
    mask = np.zeros(64, bool)
    mask[[0, 5, 31, 32]] = True
    np.testing.assert_array_equal(
        _words(tbits.pack_bits(torch.from_numpy(mask))),
        [(1 << 0) | (1 << 5) | (1 << 31), 1])


def test_per_shard_concat_equals_full_pack():
    mask = np.random.default_rng(3).random(8 * 64) < 0.4
    full = _words(tbits.pack_bits(torch.from_numpy(mask)))
    per_shard = np.concatenate([
        _words(tbits.pack_bits(torch.from_numpy(mask[lo:lo + 64])))
        for lo in range(0, mask.size, 64)])
    np.testing.assert_array_equal(per_shard, full)


def test_all_gather_bits_over_two_ranks_matches_bool_gather():
    """Blocks of 32 (packed words move) and 24 (the bool fallback), real N
    below the pad; one spawn for both."""
    rng = np.random.default_rng(7)
    masks, ns = [], []
    for n_local in (32, 24):
        n = 2 * n_local - 3
        m = np.zeros(2 * n_local, bool)
        m[:n] = rng.random(n) < 0.5
        masks.append(m)
        ns.append(n)
    got = spawn_ranks(workers.gather_bits, 2, masks, ns, threads=1)
    for rank in got:
        for (packed, plain), m, n in zip(rank, masks, ns):
            assert packed.shape == (n,)
            np.testing.assert_array_equal(packed, m[:n])
            np.testing.assert_array_equal(plain, m[:n])
