"""The port's selection core vs the JAX package, bit for bit.

Covers the top-k cut (stable (score, id) tie-break), the cohort layout,
the rate EMA (held against the *jitted* JAX function: the engines run
jitted, and jitted XLA contracts the EMA into one FMA), the f3ast score,
and the plain ``fed_select`` / ``fed_select_mask`` against the JAX
kernel's Pallas interpreter run and its jitted reference, in all four
weight modes.  Bitwise everywhere except the ``fedavg`` weights, whose
float sum is taken in another order (rtol 1e-6).
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import hfun as jhfun
from repro.core import rates as jrates
from repro.core import selection as jsel
from repro.core.strategies import make_strategy as jmake_strategy
from repro.kernels import fed_select as jfs
from repro.kernels import ref as jref
from repro_torch import random as tr
from repro_torch.core import hfun as thfun
from repro_torch.core import rates as trates
from repro_torch.core import selection as tsel
from repro_torch.core.strategies import make_strategy as tmake_strategy
from repro_torch.kernels import fed_select as tfs
from repro_torch.kernels import ref as tref

MODES = ("unbiased", "unbiased_frozen", "uniform", "fedavg")


def assert_bitwise(got, want, msg=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (msg, got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), msg


def _case(n, seed, ties=False, q=0.5):
    """The inputs of tests/test_kernels_select.py, from numpy."""
    rng = np.random.default_rng(seed)
    if ties:
        scores = rng.integers(0, 4, n).astype(np.float32)
    else:
        scores = rng.normal(size=n).astype(np.float32)
    return scores, rng.random(n) < q


def _select_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    scores, avail = _case(n, seed=seed + 1, ties=True)
    r = rng.random(n).astype(np.float32)
    p = rng.dirichlet(np.ones(n)).astype(np.float32)
    rw = (rng.random(n) * 0.9 + 0.05).astype(np.float32)
    return scores, avail, r, p, rw


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("n", [32, 100, 513])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [0, 1, 7, 10_000])
def test_topk_mask_matches_jax(n, ties, k):
    scores, avail = _case(n, seed=n + k, ties=ties)
    want = jax.jit(jsel._topk_mask)(jnp.asarray(scores), jnp.asarray(avail),
                                    jnp.asarray(k, jnp.int32))
    ts, ta = _t(scores, avail)
    kk = torch.tensor(k, dtype=torch.int32)
    assert_bitwise(tsel._topk_mask(ts, ta, kk), want, f"n={n} k={k}")
    assert_bitwise(tref.topk_threshold_mask(ts, ta, kk), want,
                   f"threshold n={n} k={k}")


def test_tie_break_is_lowest_id_first():
    scores = torch.zeros(12)
    avail = torch.tensor([0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1], dtype=torch.bool)
    want = np.zeros(12, bool)
    want[[1, 2, 4, 5]] = True
    k = torch.tensor(4, dtype=torch.int32)
    for cut in (tsel._topk_mask, tref.topk_threshold_mask,
                tfs.fed_select_mask):
        np.testing.assert_array_equal(cut(scores, avail, k).numpy(), want)


@pytest.mark.parametrize("n,k", [(100, 10), (100, 3), (37, 10)])
def test_cohort_ids_from_mask(n, k):
    rng = np.random.default_rng(n + k)
    for _ in range(5):
        mask = rng.random(n) < 0.1
        mask[rng.integers(n)] = True            # never empty
        ids_j, valid_j = jsel.cohort_ids_from_mask(jnp.asarray(mask), k)
        ids_t, valid_t = tsel.cohort_ids_from_mask(torch.from_numpy(mask), k)
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        assert_bitwise(valid_t, valid_j)


@pytest.mark.parametrize("beta", [1e-3, 0.1, 0.37])
def test_update_rates_matches_jitted_jax(beta):
    rng = np.random.default_rng(11)
    n = 1 << 16
    r = rng.random(n).astype(np.float32)
    m = rng.random(n) < 0.3
    step = jax.jit(lambda r, m: jrates.update_rates(
        jrates.RateState(r=r, t=jnp.zeros((), jnp.int32)), m, beta).r)
    want = step(jnp.asarray(r), jnp.asarray(m))
    tr_, tm = _t(r, m)
    got = trates.update_rates(trates.RateState(r=tr_, t=torch.tensor(0)),
                              tm, beta).r
    assert_bitwise(got, want, f"beta={beta}")


def test_f3ast_score_matches_jitted_jax():
    rng = np.random.default_rng(3)
    n = 4096
    r = rng.random(n).astype(np.float32)
    p = rng.dirichlet(np.ones(n)).astype(np.float32)
    jk, tk = jax.random.PRNGKey(5), tr.PRNGKey(5, device="cpu")

    def jscore(r, p, key):
        util = jhfun.marginal_utility(r, p, False)
        return util * (1.0 + 1e-6 * jax.random.uniform(key, util.shape))

    want = jax.jit(jscore)(jnp.asarray(r), jnp.asarray(p), jk)
    tr_, tp = _t(r, p)
    util = thfun.marginal_utility(tr_, tp, False)
    got = util * (1.0 + 1e-6 * tr.uniform(tk, n))
    assert_bitwise(got, want)


def _jax_fed_select_variants(scores, avail, k, r, p, rw, beta, mode):
    args = [jnp.asarray(x) for x in (scores, avail)]
    kk = jnp.asarray(k, jnp.int32)
    rj, pj, rwj = (jnp.asarray(x) for x in (r, p, rw))
    rwt = rwj if mode == "unbiased_frozen" else None
    interp = jfs.fed_select(*args, kk, rj, pj, beta, weight_mode=mode,
                            r_weight=rwt, interpret=True)
    jitted = jax.jit(lambda s, a, k, r, p, rw: jref.fed_select_ref(
        s, a, k, r, p, beta, weight_mode=mode, r_weight=rw))(
            *args, kk, rj, pj, rwt)
    return {"interpret": interp, "jitted_ref": jitted}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [64, 100, 513])
def test_plain_fed_select_matches_jax_kernel(mode, n):
    scores, avail, r, p, rw = _select_inputs(n, seed=n)
    beta, k = 1e-3, 9
    ts, ta, trr, tp, trw = _t(scores, avail, r, p, rw)
    got = tfs.fed_select(ts, ta, torch.tensor(k, dtype=torch.int32), trr, tp,
                         beta, weight_mode=mode,
                         r_weight=trw if mode == "unbiased_frozen" else None)
    for name, want in _jax_fed_select_variants(scores, avail, k, r, p, rw,
                                                beta, mode).items():
        assert_bitwise(got[0], want[0], f"{mode} {name} mask")
        assert_bitwise(got[1], want[1], f"{mode} {name} new_r")
        if mode == "fedavg":
            np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                       rtol=1e-6, atol=0)
        else:
            assert_bitwise(got[2], want[2], f"{mode} {name} weights")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["none_avail", "all_avail_k_big", "k0"])
def test_plain_fed_select_edges(mode, case):
    n = 16
    scores = np.arange(n, dtype=np.float32)
    avail = np.zeros(n, bool) if case == "none_avail" else np.ones(n, bool)
    k = {"none_avail": 8, "all_avail_k_big": 99, "k0": 0}[case]
    rng = np.random.default_rng(0)
    r = rng.random(n).astype(np.float32)
    p = rng.dirichlet(np.ones(n)).astype(np.float32)
    rw = (rng.random(n) * 0.9 + 0.05).astype(np.float32)
    ts, ta, trr, tp, trw = _t(scores, avail, r, p, rw)
    got = tfs.fed_select(ts, ta, torch.tensor(k, dtype=torch.int32), trr, tp,
                         1e-3, weight_mode=mode,
                         r_weight=trw if mode == "unbiased_frozen" else None)
    want = _jax_fed_select_variants(scores, avail, k, r, p, rw, 1e-3,
                                    mode)["interpret"]
    assert_bitwise(got[0], want[0], f"{mode} {case} mask")
    assert_bitwise(got[1], want[1], f"{mode} {case} new_r")
    if mode == "fedavg":
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-6, atol=0)
    else:
        assert_bitwise(got[2], want[2], f"{mode} {case} weights")


@pytest.mark.parametrize("n", [100, 513])
@pytest.mark.parametrize("k", [0, 3, 513])
def test_plain_fed_select_mask_matches_interpret(n, k):
    scores, avail = _case(n, seed=n, ties=True)
    want = jfs.fed_select_mask(jnp.asarray(scores), jnp.asarray(avail),
                               jnp.asarray(k, jnp.int32), interpret=True)
    ts, ta = _t(scores, avail)
    assert_bitwise(tfs.fed_select_mask(ts, ta, k), want, f"n={n} k={k}")


def test_fed_select_rejects_other_devices():
    """A tensor neither on the CPU nor on CUDA raises: nothing falls back."""
    s = torch.zeros(8, device="meta")
    with pytest.raises(RuntimeError):
        tfs.fed_select_mask(s, torch.ones(8, dtype=torch.bool,
                                          device="meta"), 3)
    with pytest.raises(ValueError):
        tfs.fed_select(torch.zeros(8), torch.ones(8, dtype=torch.bool), 3,
                       torch.zeros(8), torch.zeros(8), 1e-3,
                       weight_mode="nope")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_f3ast_strategy_matches_jax(impl):
    """Five rounds of the f3ast strategy's select: masks, weights and r_k
    bitwise the jitted JAX strategy's (either select_impl)."""
    n, m = 100, 10
    rng = np.random.default_rng(5)
    p = rng.dirichlet(np.ones(n)).astype(np.float32)
    js = jmake_strategy("f3ast", n, jnp.asarray(p), clients_per_round=m,
                        select_impl=impl)
    ts = tmake_strategy("f3ast", n, torch.from_numpy(p), clients_per_round=m,
                        select_impl=impl, device="cpu")
    jstep = jax.jit(js.select)
    jstate, tstate = js.init(n), ts.init(n)
    jkey, tkey = jax.random.PRNGKey(0), tr.PRNGKey(0, device="cpu")
    for t in range(5):
        jkey, _, jk2 = jax.random.split(jkey, 3)
        tkey, _, tk2 = tr.split(tkey, 3)
        avail = np.random.default_rng(100 + t).random(n) < 0.5
        jm, jw, jstate = jstep(jstate, jk2, jnp.asarray(avail),
                               jnp.asarray(m, jnp.int32), None)
        tm, tw, tstate = ts.select(tstate, tk2, torch.from_numpy(avail),
                                   torch.tensor(m, dtype=torch.int32))
        assert_bitwise(tm, jm, f"round {t} mask")
        assert_bitwise(tw, jw, f"round {t} weights")
        assert_bitwise(tstate.rates.r, jstate.rates.r, f"round {t} r_k")


@pytest.mark.parametrize("n,q", [(100, 0.2), (5, 0.02), (3, 0.0)])
def test_scarce_availability_matches_jax(n, q):
    """Bernoulli draw + force_nonempty (incl. the all-down fallback, which
    q = 0 forces every round) over 20 step keys."""
    from repro.sim.processes import make_process as jmake
    from repro_torch.sim.processes import make_process as tmake
    jm, tm = jmake("scarce", n, q=q), tmake("scarce", n, q=q, device="cpu")
    step = jax.jit(lambda k, t: jm.step(k, (), t)[1])
    jkey, tkey = jax.random.PRNGKey(1), tr.PRNGKey(1, device="cpu")
    for t in range(20):
        jkey, jk = jax.random.split(jkey)
        tkey, tk = tr.split(tkey)
        want = step(jk, t)
        got = tm.step(tk, (), t)[1]
        assert_bitwise(got, want, f"t={t}")
        assert bool(got.any())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_force_nonempty_fallback_with_heterogeneous_q(seed):
    from repro.core.availability import force_nonempty as jforce
    from repro_torch.core.availability import force_nonempty as tforce
    q = np.array([0.1, 0.3, 0.3, 0.2, 0.3], np.float32)
    mask = np.zeros(5, bool)
    want = jax.jit(jforce)(jnp.asarray(mask), jnp.asarray(q),
                           jax.random.PRNGKey(seed))
    got = tforce(torch.from_numpy(mask), torch.from_numpy(q),
                 tr.PRNGKey(seed, device="cpu"))
    assert_bitwise(got, want)
    assert int(got.sum()) == 1 and q[int(got.numpy().argmax())] == 0.3
