"""repro_torch.xla_math vs jitted JAX on the CPU: XLA:CPU's float32
``exp`` and ``log`` (its inlined Cephes polynomials), ``sin`` and ``pow``
(glibc's ``sinf``/``powf``, which the compiled code calls) and
``random.gumbel``, bit for bit over 2^20 lanes at two seeds, on the
ranges the scenarios reach and wide ones; plus XLA's rewrite of a
division by a constant.  Comparisons are ``tobytes()`` equality (NaNs
compared as NaNs)."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro_torch import random as tr
from repro_torch import xla_math

LANES = 1 << 20
SEEDS = (0, 1)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_bits(want, got):
    want, got = np.asarray(want), np.asarray(got)
    both_nan = np.isnan(want) & np.isnan(got)
    return int(((want.view(np.int32) != got.view(np.int32))
                & ~both_nan).sum())


def _draw(seed, lo, hi, n=LANES):
    return np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)


def _wide(seed, n=LANES):
    """Magnitudes from 1e-30 to 1e30, both signs."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            * 10.0 ** rng.uniform(-30, 30, n)).astype(np.float32)


SPECIAL = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, 1.17e-38, 1.0, -1.0,
                    0.785, 120.0, -120.0, 88.7, 88.8, 89.0, -87.3, -87.9,
                    -100.0, 3e38, -3e38, np.inf, -np.inf, np.nan],
                   np.float32)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(-3.0, -1.0), (-2.0, 2.0),
                                   (-100.0, 100.0)])
def test_exp(seed, lo, hi):
    """[-3, -1) and [-2, 2] hold sigma·ε of the deadline and bandwidth
    draws; past -87 the compiled code flushes to 0."""
    x = _draw(seed, lo, hi)
    assert _same_bits(jax.jit(jnp.exp)(x), xla_math.exp(
        torch.from_numpy(x))) == 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", ["unit", "wide", "uniform_draws"])
def test_log(seed, case):
    """(1e-6, 4); |x| over 60 decades (negatives: NaN); and every
    [0, 1) value ``random.uniform`` makes (the gumbel and log p inputs)."""
    if case == "unit":
        x = _draw(seed, 1e-6, 4.0)
    elif case == "wide":
        x = _wide(seed)
    else:
        bits = np.random.default_rng(seed).integers(0, 1 << 23, LANES)
        x = ((bits.astype(np.uint32) | 0x3F800000).view(np.float32) - 1.0)
    assert _same_bits(jax.jit(jnp.log)(x), xla_math.log(
        torch.from_numpy(x))) == 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", ["phases", "reduced", "wide"])
def test_sin(seed, case):
    """[0, 26π) (the diurnal phases over 300 rounds); |x| < 1e6, through
    both of glibc's reductions; and 60 decades."""
    x = {"phases": lambda: _draw(seed, 0.0, 26 * math.pi),
         "reduced": lambda: _draw(seed, -1e6, 1e6),
         "wide": lambda: _wide(seed)}[case]()
    assert _same_bits(jax.jit(jnp.sin)(x), xla_math.sin(
        torch.from_numpy(x))) == 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("y", [0.5, 1.7, 2.3])
def test_pow_on_marginals(seed, y):
    """q ** gamma for q in [0, 1): availability_coupled's rate."""
    q = _draw(seed, 0.0, 1.0)
    assert _same_bits(jax.jit(lambda a: a ** y)(q), xla_math.pow(
        torch.from_numpy(q), y)) == 0


@pytest.mark.parametrize("y", [0.0, 1.0, 2.0, 3.0, -1.0, 0.5, -0.5, 0.25,
                               1.7, 4.0])
def test_pow_exponents_and_wide_bases(y):
    """Each exponent XLA rewrites (0, 1, 2, 3, -1, 0.5) and some it sends
    to ``powf``, over bases from 1e-44 to 1e35 and the special values."""
    q = np.exp(np.random.default_rng(5).uniform(-100, 80, LANES // 4))
    q = np.concatenate([q.astype(np.float32), np.abs(SPECIAL)])
    assert _same_bits(jax.jit(lambda a: a ** y)(q), xla_math.pow(
        torch.from_numpy(q), y)) == 0


@pytest.mark.parametrize("fn", ["exp", "log", "sin"])
def test_special_values(fn):
    want = jax.jit(getattr(jnp, fn))(SPECIAL)
    got = getattr(xla_math, fn)(torch.from_numpy(SPECIAL))
    assert _same_bits(want, got) == 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(LANES,), (100,), (), (3, 7)])
def test_gumbel(seed, shape):
    want = jax.jit(lambda k: jax.random.gumbel(k, shape))(
        jax.random.PRNGKey(seed))
    got = tr.gumbel(tr.PRNGKey(seed, device="cpu"), shape)
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    assert np.asarray(want).tobytes() == got.numpy().tobytes()


@pytest.mark.parametrize("period", [3, 7, 13, 24, 48, 150])
def test_division_by_a_constant_is_xlas_reciprocal(period):
    """XLA rewrites ``2π · x / period`` into ``x · (2π · (1/period))`` (and
    ``x / c`` into ``x · (1/c)``) with the constants folded in float32;
    the two spellings differ at period 7 and 150."""
    t = np.arange(400, dtype=np.float32)
    want = jax.jit(lambda x: 2.0 * jnp.pi * x / period)(t)
    got = torch.from_numpy(t) * xla_math.two_pi_over(period)
    assert np.asarray(want).tobytes() == got.numpy().tobytes()
    want = jax.jit(lambda x: x / period)(t)
    got = torch.from_numpy(t) * xla_math.recip(period)
    assert np.asarray(want).tobytes() == got.numpy().tobytes()


def test_fma64_is_one_rounding():
    """The float64 FMA of the glibc routines rounds once: exact against
    rational arithmetic on products whose low bits a two-step a*b + c
    loses."""
    from fractions import Fraction
    rng = np.random.default_rng(2)
    a = rng.normal(size=2000) * 10.0 ** rng.uniform(-3, 3, 2000)
    b = rng.normal(size=2000)
    c = -(a * b) * (1 + rng.normal(size=2000) * 1e-9)
    got = xla_math._fma64(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(c)).numpy()
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a, b, c)]
    assert got.tobytes() == np.array(want).tobytes()
    assert (got != a * b + c).any()
