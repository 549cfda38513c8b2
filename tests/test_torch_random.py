"""repro_torch.random vs jax.random: the key stream, bit for bit.

Every mask of the F3AST trajectory comes from threefry draws, so the port's
threefry must give the same bytes as ``jax.random`` under the installed
config (partitionable threefry).  Comparisons are ``tobytes()`` equality.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import keys as jkeys
from repro_torch import random as tr
from repro_torch.core import keys as tkeys

SEEDS = (0, 7, 123456789)
LENGTHS = (1, 2, 7, 100, 1000, 1025)


def _bytes(x):
    return np.asarray(x).tobytes()


def _key_pair(seed):
    return jax.random.PRNGKey(seed), tr.PRNGKey(seed, device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    jk, tk = _key_pair(seed)
    assert _bytes(jk) == tr.key_data(tk).tobytes()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", (2, 3, 5, 7))
def test_split(seed, num):
    jk, tk = _key_pair(seed)
    assert _bytes(jax.random.split(jk, num)) == \
        tr.key_data(tr.split(tk, num)).tobytes()


def test_key_fold_constants_match():
    assert tkeys.COMPLETION == jkeys.COMPLETION == 0x5E1EC7
    assert tkeys.NONEMPTY == jkeys.NONEMPTY == 1
    assert tkeys.KEY_FOLDS == jkeys.KEY_FOLDS


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fold", ("COMPLETION", "NONEMPTY"))
def test_fold_in_key_folds(seed, fold):
    jk, tk = _key_pair(seed)
    # fold into a split-off key too, as the engine does (k_sel, k_av)
    for j, t in ((jk, tk), (jax.random.split(jk, 5)[2],
                            tr.split(tk, 5)[2])):
        want = jax.random.fold_in(j, getattr(jkeys, fold))
        got = tr.fold_in(t, getattr(tkeys, fold))
        assert _bytes(want) == tr.key_data(got).tobytes()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", LENGTHS)
def test_bits_uniform(seed, n):
    jk, tk = _key_pair(seed)
    assert _bytes(jax.random.bits(jk, (n,))) == \
        tr.key_data(tr.bits(tk, n)).tobytes()
    assert _bytes(jax.random.uniform(jk, (n,))) == \
        tr.uniform(tk, n).numpy().tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_scalar_and_2d(seed):
    jk, tk = _key_pair(seed)
    assert _bytes(jax.random.uniform(jk)) == tr.uniform(tk).numpy().tobytes()
    assert _bytes(jax.random.uniform(jk, (3, 5))) == \
        tr.uniform(tk, (3, 5)).numpy().tobytes()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", LENGTHS)
def test_bernoulli_vector_p(seed, n):
    jk, tk = _key_pair(seed)
    p = np.random.default_rng(n).random(n).astype(np.float32)
    want = jax.random.bernoulli(jk, jnp.asarray(p))
    got = tr.bernoulli(tk, torch.from_numpy(p))
    assert got.dtype == torch.bool
    assert _bytes(want) == got.numpy().tobytes()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p", (0.0, 0.2, 0.5, 1.0))
def test_bernoulli_scalar_p(seed, p):
    jk, tk = _key_pair(seed)
    assert _bytes(jax.random.bernoulli(jk, p)) == \
        tr.bernoulli(tk, p).numpy().tobytes()
    assert _bytes(jax.random.bernoulli(jk, p, (100,))) == \
        tr.bernoulli(tk, p, 100).numpy().tobytes()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("counts", ([1, 80, 7, 1000, 3], [80] * 10,
                                    [1, 1, 1], [2 ** 31 - 1, 5, 65537]))
def test_randint_per_row_bounds(seed, counts):
    """The cohort gather's draw: shape (K, E, B), bounds counts[:, None,
    None] — including a bound of 1 and a bound past 2**16."""
    jk, tk = _key_pair(seed)
    c = np.asarray(counts, np.int32)
    shape = (len(counts), 5, 20)
    want = jax.random.randint(jk, shape, 0, jnp.asarray(c)[:, None, None])
    got = tr.randint(tk, shape, 0, torch.from_numpy(c)[:, None, None])
    assert got.dtype == torch.int32
    assert _bytes(want) == got.numpy().tobytes()


@pytest.mark.parametrize("lo,hi", ((0, 10), (-100, 2 ** 31 - 1), (5, 5),
                                   (7, 3)))
def test_randint_scalar_bounds(lo, hi):
    jk, tk = _key_pair(3)
    want = jax.random.randint(jk, (257,), lo, hi)
    assert _bytes(want) == tr.randint(tk, 257, lo, hi).numpy().tobytes()
