"""repro_torch.random vs jax.random: the key stream, bit for bit.

Every mask of the F3AST trajectory comes from threefry draws, so the port's
threefry must give the same bytes as ``jax.random`` under the installed
config (partitionable threefry).  Comparisons are ``tobytes()`` equality.
"""
from fractions import Fraction

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import keys as jkeys
from repro_torch import random as tr
from repro_torch import xla_math
from repro_torch.core import keys as tkeys

SEEDS = (0, 7, 123456789)
LENGTHS = (1, 2, 7, 100, 1000, 1025)


def _bytes(x):
    return np.asarray(x).tobytes()


def _key_pair(seed):
    return jax.random.PRNGKey(seed), tr.PRNGKey(seed, device="cpu")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Each test on one intra-op thread.  The parameter draws are ~1,000
    small elementwise ops a chunk; with torch's default threads, test
    workers that share the cores spend most of their time in those ops'
    thread barriers (one draw test took minutes in a six-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# ---------------------------------------------------------------------------
# normal: XLA's erf_inv and log1p spelled op for op (repro_torch.xla_math)
# ---------------------------------------------------------------------------

NORMAL_SEEDS = (0, 3, 7, 123456789)


@pytest.mark.parametrize("seed", NORMAL_SEEDS)
def test_normal_is_jax_normal_bitwise_tail_included(seed):
    """2^16 lanes: every lane is bitwise, and the erf_inv's second branch
    (w = -log1p(-u^2) >= 5, |z| > ~2.75) is among them."""
    jk, tk = _key_pair(seed)
    want = np.asarray(jax.random.normal(jk, (1 << 16,)))
    got = tr.normal(tk, 1 << 16).numpy()
    assert got.dtype == np.float32
    assert want.tobytes() == got.tobytes()
    u = tr.uniform(tk, 1 << 16, -1.0 + 2.0 ** -24, 1.0)
    tail = (-xla_math.log1p(u * -u) >= 5.0).sum().item()
    assert tail > 0


@pytest.mark.parametrize("seed", NORMAL_SEEDS)
def test_normal_odd_2d_shape(seed):
    jk, tk = _key_pair(seed)
    want = np.asarray(jax.random.normal(jk, (37, 51)))
    got = tr.normal(tk, (37, 51))
    assert tuple(got.shape) == (37, 51)
    assert want.tobytes() == got.numpy().tobytes()


@pytest.mark.parametrize("seed", NORMAL_SEEDS)
@pytest.mark.parametrize("lo,hi", ((-1.0 + 2.0 ** -24, 1.0), (-3.0, 5.5),
                                   (0.1, 0.7)))
def test_uniform_on_a_range(seed, lo, hi):
    jk, tk = _key_pair(seed)
    want = jax.random.uniform(jk, (4099,), jnp.float32, lo, hi)
    assert _bytes(want) == tr.uniform(tk, 4099, lo, hi).numpy().tobytes()


@pytest.mark.parametrize("seed", NORMAL_SEEDS)
def test_log1p_is_jitted_jnp_log1p_on_erf_inv_inputs(seed):
    """log1p over what erf_inv feeds it, -u*u for u uniform on (-1, 1)
    (both of its branches: |y| below and above sqrt(2) - 1)."""
    _, tk = _key_pair(seed)
    u = tr.uniform(tk, 1 << 16, -1.0 + 2.0 ** -24, 1.0)
    y = u * -u
    assert (y.abs() < 0.41421356).any() and (y.abs() > 0.41421356).any()
    want = np.asarray(jax.jit(jnp.log1p)(jnp.asarray(y.numpy())))
    assert want.tobytes() == xla_math.log1p(y).numpy().tobytes()


def test_log1p_and_erf_inv_off_the_draw():
    """log1p on (-1, 10) and erf_inv on (-1, 1) as plain float32 inputs,
    and the edges: erf_inv(+-1) = +-inf, log1p(-1) = -inf."""
    rng = np.random.default_rng(11)
    y = rng.uniform(-1, 10, 1 << 15).astype(np.float32)
    y[:2] = (-1.0, 0.0)
    want = np.asarray(jax.jit(jnp.log1p)(y))
    assert want.tobytes() == xla_math.log1p(torch.from_numpy(y)).numpy() \
        .tobytes()
    x = rng.uniform(-1, 1, 1 << 15).astype(np.float32)
    x[:3] = (-1.0, 1.0, 0.0)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    assert want.tobytes() == xla_math.erf_inv(torch.from_numpy(x)).numpy() \
        .tobytes()


def test_fma_and_sqrt_round_once():
    """fma against exact rational arithmetic on random float32 triples
    (including exact halfway cases of the float64 sum), sqrt against
    numpy's correctly rounded float32 root."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal(4096).astype(np.float32)
    b = rng.standard_normal(4096).astype(np.float32)
    c = rng.standard_normal(4096).astype(np.float32)
    # the float64 sum lands on a float32 midpoint that the exact sum is
    # just below: 1 + 2^-23 + (2^-24 - 2^-70) rounds to 1 + 2^-23, where
    # rounding twice to nearest would give the even 1 + 2^-22
    a[:64] = np.float32(2.0 ** -24 * (1 + 2.0 ** -23))
    b[:64] = np.float32(1 - 2.0 ** -23)
    c[:64] = np.float32(1 + 2.0 ** -23)
    got = xla_math.fma(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c)).numpy()
    for i in range(0, 4096, 7):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        r = got[i]
        lo_n = np.nextafter(r, np.float32(-np.inf))
        hi_n = np.nextafter(r, np.float32(np.inf))
        assert abs(Fraction(float(r)) - exact) <= \
            min(abs(Fraction(float(lo_n)) - exact),
                abs(Fraction(float(hi_n)) - exact)), i
    assert got[0] == np.nextafter(np.float32(1), np.float32(2))
    x = np.abs(rng.standard_normal(1 << 15).astype(np.float32)) * 30
    assert np.sqrt(x).tobytes() == xla_math.sqrt(torch.from_numpy(x)) \
        .numpy().tobytes()


@pytest.mark.parametrize("seed", (0, 7))
def test_chunked_draw_equals_the_whole_one(seed):
    _, tk = _key_pair(seed)
    whole = tr.normal(tk, 10_000)
    parts = torch.cat([tr.normal(tk, m, start=s)
                       for s, m in ((0, 4096), (4096, 4096), (8192, 1808))])
    assert torch.equal(whole, parts)
    assert torch.equal(tr.bits(tk, (5, 7), start=13),
                       tr.bits(tk, 48)[13:].reshape(5, 7))


def test_split_of_a_stack_of_keys_is_vmap_split():
    jk, tk = _key_pair(9)
    jks, tks = jax.random.split(jk, 5), tr.split(tk, 5)
    want = jax.vmap(lambda k: jax.random.split(k, 3))(jks)
    assert _bytes(want) == tr.key_data(tr.split(tks, 3)).tobytes()
