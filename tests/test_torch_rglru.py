"""The port's RG-LRU block (``models.ssm``: recurrentgemma-2b's recurrent
mixer) against the JAX package, on the CPU, at the smoke config's widths
(d 128, lru_width 128, conv width 4, float32 unless stated).

* ``init_rglru`` byte for byte JAX's (float32 and bfloat16, two seeds, a
  stack of keys), ``lam`` (computed, not drawn) within an ulp; the float32
  ``linspace`` under it bitwise ``jnp.linspace`` at widths up to 256 and
  at recurrentgemma-2b's 2,560 (above 352 lanes XLA:CPU's vectorised loop
  fuses ``1 - i r`` too, except in its scalar tail).
* ``_rglru_gates`` (a; ``gated`` within an ulp of exp through the
  1 - a^2 cancellation) and ``rglru_block`` within 1e-6 relative at
  S = 1, 7, 64 and 1,000; the scan alone is bitwise
  ``lax.associative_scan`` run op by op (jitted, XLA fuses a2 b1 + b2
  into one FMA: within 1e-6 then).
* ``rglru_decode`` stepped S times against ``rglru_block`` and JAX's.

The whole hybrid model is held in ``tests/test_torch_hybrid.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import random as jr  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

ARCH = "recurrentgemma-2b"
SMOKE_J = jconfigs.get_arch(ARCH).smoke_model
SMOKE_T = tconfigs.get_arch(ARCH).smoke_model
RTOL = 1e-6


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _np(x):
    return (x.detach().float().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32))


def _max_err(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _rel_err(got, want):
    return _max_err(got, want) / float(np.abs(_np(want)).max())


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def _same_bytes(jtree, ttree):
    """Every leaf's bytes equal; ``lam`` within an ulp."""
    jl = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jtree))
    tl = jax.tree_util.tree_leaves_with_path(params_to_numpy(ttree))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if jax.tree_util.keystr(path).endswith("['lam']"):
            assert _ulps(a, b) <= 1, path
        else:
            assert a.tobytes() == b.tobytes(), path


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 3))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_rglru_bitwise(dtype, seed):
    """One key, and a stack of two (the stacked layers' vmapped draw);
    b_a, b_i and lam stay float32 in a bfloat16 model."""
    jcfg, tcfg = SMOKE_J.replace(dtype=dtype), SMOKE_T.replace(dtype=dtype)
    key = jax.random.PRNGKey(seed)
    p = tssm.init_rglru(jr.PRNGKey(seed, device="cpu"), tcfg)
    _same_bytes(jssm.init_rglru(key, jcfg), p)
    assert p["lam"].dtype == p["b_a"].dtype == torch.float32
    assert p["w_a"].dtype == tcfg.torch_dtype
    keys = jax.random.split(key, 2)
    _same_bytes(jax.vmap(lambda k: jssm.init_rglru(k, jcfg))(keys),
                tssm.init_rglru(jr.split(jr.PRNGKey(seed, device="cpu"), 2),
                                tcfg))


@pytest.mark.parametrize("n", (1, 2, 7, 64, 128, 256, 2560))
def test_linspace_bitwise_and_lam_within_an_ulp(n):
    """``lam``'s float32 linspace is bitwise JAX's: near a = 0.999 one ulp
    of x moves lam by ~60 ulps, so a plain ``torch.linspace`` would not
    do (it differs in ~40% of the lanes).  At 2,560 lanes the fused
    ``1 - i r`` matters: without it 468 lanes differ and lam by up to 41
    ulps.  (The drawn leaves are left on the meta device: lam is not
    drawn.)"""
    want = np.asarray(jnp.linspace(0.9, 0.999, n))
    got = tssm._xla_linspace(0.9, 0.999, n, "cpu").numpy()
    assert got.tobytes() == want.tobytes()
    jlam = jnp.log(jnp.expm1(-jnp.log(jnp.linspace(0.9, 0.999, n))
                             / jssm._RG_C))
    with tL.shapes_only():
        tlam = tssm.init_rglru(jr.PRNGKey(0, device="cpu"),
                               SMOKE_T.replace(lru_width=n))["lam"]
    assert _ulps(tlam.numpy(), np.asarray(jlam)) <= 1
    if n == 2560:       # recurrentgemma-2b's width, through init_rglru
        jp = jssm.init_rglru(jax.random.PRNGKey(0),
                             SMOKE_J.replace(lru_width=n))
        assert _ulps(tlam.numpy(), np.asarray(jp["lam"])) <= 1
    if n >= 64:
        assert (torch.linspace(0.9, 0.999, n).numpy() != want).any()


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rglru_params():
    jp = jssm.init_rglru(jax.random.PRNGKey(4), SMOKE_J)
    return jp, _to_torch(jp)


def _x(S, seed=5):
    return np.random.default_rng(seed + S).normal(
        size=(2, S, SMOKE_J.d_model)).astype(np.float32)


@pytest.mark.parametrize("S", (1, 7, 64, 1000))
def test_rglru_gates_and_block_match_jax(S):
    """a and the block within 1e-6 relative.  ``gated`` =
    sqrt(1 - exp(2 log_a)) i u lane by lane within one float32 ulp of
    exp(2 log_a) carried through the cancellation, plus 1e-6 relative:
    torch's exp and XLA:CPU's round differently by up to an ulp, and
    1 - a^2 cancels down to ~2e-3 (a up to 0.999), where that ulp is
    ~3e-5 of the lane (the largest lane then moves 1.3e-6 of the largest
    at S = 1000)."""
    jp, tp = _rglru_params()
    x = _x(S)
    u = np.random.default_rng(S).normal(
        size=(2, S, SMOKE_J.lru_width)).astype(np.float32)
    ja, jg = jssm._rglru_gates(jp, jnp.asarray(u))
    ta, tg = tssm._rglru_gates(tp, torch.from_numpy(u))
    assert ta.dtype == tg.dtype == torch.float32
    assert _rel_err(ta, ja) <= RTOL
    a, iu = np.asarray(ja, np.float64), np.abs(np.asarray(jg)) \
        / np.sqrt(np.maximum(1.0 - np.asarray(ja, np.float64) ** 2, 1e-12))
    one_ulp = iu * 2.0 ** -25 / np.sqrt(np.maximum(1.0 - a ** 2, 1e-12))
    assert (np.abs(_np(tg) - np.asarray(jg))
            <= one_ulp + RTOL * np.abs(np.asarray(jg))).all()
    want = jssm.rglru_block(jp, jnp.asarray(x), SMOKE_J)
    got = tssm.rglru_block(tp, torch.from_numpy(x), SMOKE_T)
    assert got.shape == (2, S, SMOKE_J.d_model)
    assert _rel_err(got, want) <= RTOL


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("S", (1, 7, 64, 1000))
def test_scan_is_bitwise_lax_associative_scan(S):
    """The odd/even recursion spelled as JAX's, on JAX's own (a, gated):
    bitwise the op-by-op ``lax.associative_scan``; within 1e-6 of the
    jitted one, whose a2 b1 + b2 XLA contracts into an FMA."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.9, 0.999, (2, S, 128)).astype(np.float32)
    b = rng.normal(size=(2, S, 128)).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    want = jax.lax.associative_scan(_combine, (ja, jb), axis=1)
    got = tssm._linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    jitted = jax.jit(lambda a, b: jax.lax.associative_scan(
        _combine, (a, b), axis=1))(ja, jb)[1]
    assert _rel_err(got[1], jitted) <= RTOL
    # and it is the recurrence h_t = a_t h_{t-1} + b_t
    h, hs = np.zeros((2, 128), np.float64), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    assert _rel_err(got[1], np.stack(hs, 1)) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_decode_steps_match_block(dtype):
    """S = 40 single steps (the state updated in place) against the block
    over the whole sequence, and each step against JAX's."""
    jcfg, tcfg = SMOKE_J.replace(dtype=dtype), SMOKE_T.replace(dtype=dtype)
    jp = jssm.init_rglru(jax.random.PRNGKey(6), jcfg)
    tp = _to_torch(jp)
    S = 40
    x = torch.from_numpy(_x(S, 9)).to(tcfg.torch_dtype)
    full = tssm.rglru_block(tp, x, tcfg)
    state = tssm.rglru_init_state(tcfg, 2, tcfg.torch_dtype, "cpu")
    jstate = jssm.rglru_init_state(jcfg, 2, jcfg.np_dtype)
    h = state["h"]
    steps = []
    for t in range(S):
        y, state = tssm.rglru_decode(tp, x[:, t:t + 1], tcfg, state)
        jy, jstate = jssm.rglru_decode(jp, jnp.asarray(_np(x[:, t:t + 1]),
                                                       jcfg.np_dtype),
                                       jcfg, jstate)
        assert state["h"] is h                          # in place
        steps.append(y)
        if dtype == "float32":
            assert _rel_err(y, jy) <= 1e-5
            assert _rel_err(state["h"], jstate["h"]) <= 1e-5
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert _rel_err(torch.cat(steps, 1), full) <= tol
