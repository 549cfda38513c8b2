"""Each scenario axis of the port alone against the JAX package: every
availability process, budget schedule and completion process stepped for
50 rounds through jitted JAX (``t`` traced, as in the engine) and through
the port on the CPU — masks, K_t and completed masks bitwise, marginals
and completion rates within 1e-6 (mirrors ``tests/test_sim.py``,
``tests/test_completion.py`` and ``tests/test_availability.py``)."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import availability as jav
from repro.sim import budgets as jb
from repro.sim import completion as jc
from repro.sim import processes as jp
from repro_torch import random as tr
from repro_torch.core import availability as tav
from repro_torch.sim import budgets as tb
from repro_torch.sim import completion as tc
from repro_torch.sim import processes as tp

N = 100
ROUNDS = 50


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
P = np.random.default_rng(0).dirichlet(np.ones(N)).astype(np.float32)

PROCESSES = [
    ("always", {}), ("scarce", {"q": 0.2}), ("homedevices", {}),
    ("homedevices", {"sigma": 1.0, "seed": 4}), ("smartphones", {}),
    ("uneven", {}), ("uneven", {"q_max": 0.5}),
    ("bernoulli", {"q": 0.6, "sigma": 0.5}), ("bernoulli", {"q": 0.3}),
    ("markov", {}), ("markov", {"n_clusters": 7, "q_down": 0.0}),
    ("gilbert_elliott", {}), ("gilbert_elliott", {"init_up_fraction": 0.3}),
    ("diurnal", {}), ("diurnal", {"period": 7, "phase_spread": False}),
    ("drift", {"horizon": 150}), ("drift", {"horizon": 30}),
    ("trace", {"length": 48, "seed": 0}), ("trace", {"length": 12,
                                                     "seed": 3}),
]
BUDGETS = [
    ("constant", {"k": 10}), ("jittered", {"k": 10, "jitter": 3}),
    ("step", {"k_before": 10, "k_after": 3, "t_switch": 25}),
    ("diurnal", {"k_min": 2, "k_hi": 10, "period": 24}),
    ("diurnal", {"k_min": 1, "k_hi": 9, "period": 7, "phase": 0.5}),
    ("bandwidth", {"k_cap": 10}),
    ("bandwidth", {"k_cap": 20, "sigma": 0.5, "period": 13,
                   "mbps_per_client": 7.0}),
]
COMPLETIONS = [
    ("always", {}, None), ("bernoulli", {"q": 0.8}, None),
    ("bernoulli", {"q": 0.7, "sigma": 0.5, "seed": 3}, None),
    ("availability_coupled", {"gamma": 1.0, "floor": 0.05},
     ("bernoulli", {"q": 0.6, "sigma": 0.5})),
    ("availability_coupled", {"gamma": 1.7, "floor": 0.05}, ("diurnal", {})),
    ("availability_coupled", {"gamma": 0.5, "floor": 0.1},
     ("drift", {"horizon": 30})),
    ("availability_coupled", {"gamma": 2.3}, ("smartphones", {})),
    ("deadline", {"deadline": 1.0, "spread": 0.4}, None),
    ("deadline", {"deadline": 0.8, "spread": 0.6, "sigma": 0.5, "seed": 2},
     None),
    ("deadline", {"deadline": 1.0, "spread": 0.5, "sigma": 0.0}, None),
]


def _keys(seed):
    """The per-round keys of both packages: a split chain."""
    jk, tk = jax.random.PRNGKey(seed), tr.PRNGKey(seed, device="cpu")
    for _ in range(ROUNDS):
        jk, j = jax.random.split(jk)
        tk, t = tr.split(tk)
        yield j, t


def _bits(x):
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("name,kw", PROCESSES)
def test_process_matches_jax(name, kw):
    jm = jp.make_process(name, N, p=P, **kw)
    tm = tp.make_process(name, N, p=P, device="cpu", **kw)
    step, marg = jax.jit(jm.step), jax.jit(jm.marginals)
    js, ts = jm.init(), tm.init()
    for t, (jk, tk) in enumerate(_keys(0)):
        js, jmask = step(jk, js, jnp.int32(t))
        ts, tmask = tm.step(tk, ts, t)
        assert _bits(jmask) == _bits(tmask.numpy()), t
        assert tmask.any()
        np.testing.assert_allclose(tm.marginals(t).numpy(),
                                   np.asarray(marg(jnp.int32(t))),
                                   rtol=0, atol=1e-6)
    if name in ("markov", "gilbert_elliott"):
        assert _bits(js) == _bits(ts.numpy())


@pytest.mark.parametrize("name,kw", BUDGETS)
def test_budget_matches_jax(name, kw):
    jm, tm = jb.make_budget(name, **kw), tb.make_budget(name, device="cpu",
                                                       **kw)
    assert jm.k_max == tm.k_max
    sample = jax.jit(jm.sample)
    got = []
    for t, (jk, tk) in enumerate(_keys(0)):
        k = tm.sample(tk, t)
        assert k.dtype == torch.int32 and k.shape == ()
        assert int(sample(jk, jnp.int32(t))) == int(k), t
        got.append(int(k))
    assert 1 <= min(got) and max(got) <= tm.k_max
    if name != "constant":
        assert len(set(got)) > 1


def _completion_pair(name, kw, av):
    ja = jp.make_process(av[0], N, p=P, **av[1]) if av else None
    ta = tp.make_process(av[0], N, p=P, device="cpu", **av[1]) if av \
        else None
    return (jc.make_completion(name, N, avail_model=ja, **kw),
            tc.make_completion(name, N, avail_model=ta, device="cpu", **kw))


@pytest.mark.parametrize("name,kw,av", COMPLETIONS)
def test_completion_matches_jax(name, kw, av):
    jm, tm = _completion_pair(name, kw, av)
    assert (jm.trivial, jm.has_latency) == (tm.trivial, tm.has_latency)
    sample, rate = jax.jit(jm.sample), jax.jit(jm.rate)
    latencies = jax.jit(jm.latencies)
    rng = np.random.default_rng(7)
    done = 0
    for t in range(ROUNDS):        # PRNGKey(t), as test_completion.py
        jk, tk = jax.random.PRNGKey(t), tr.PRNGKey(t, device="cpu")
        sel = rng.random(N) < 0.3
        want = sample(jk, jnp.int32(t), jnp.asarray(sel))
        got = tm.sample(tk, t, torch.from_numpy(sel))
        assert _bits(want) == _bits(got.numpy()), t
        assert not (got.numpy() & ~sel).any()
        done += int(got.sum())
        np.testing.assert_allclose(tm.rate(t).numpy(),
                                   np.asarray(rate(jnp.int32(t))),
                                   rtol=0, atol=1e-6)
        if tm.has_latency:
            assert _bits(latencies(jk, jnp.int32(t))) == \
                _bits(tm.latencies(tk, t).numpy())
    assert 0 < done


def test_core_availability_models_match_jax():
    """``core.availability``'s samplers and ``CommBudget`` directly, at
    ``tests/test_availability.py``'s sizes and key."""
    n = 100
    pairs = [(jav.Always(n), tav.Always(n, device="cpu")),
             (jav.Scarce(n, q=0.2), tav.Scarce(n, q=0.2, device="cpu")),
             (jav.HomeDevices(n), tav.HomeDevices(n, device="cpu")),
             (jav.SmartPhones(n), tav.SmartPhones(n, device="cpu")),
             (jav.Uneven(n, p=tuple(P.tolist())),
              tav.Uneven(n, p=tuple(P.tolist()), device="cpu"))]
    for jm, tm in pairs:
        sample, probs = jax.jit(jm.sample), jax.jit(jm.probs)
        for t, (jk, tk) in enumerate(_keys(0)):
            assert _bits(sample(jk, jnp.int32(t))) == \
                _bits(tm.sample(tk, t).numpy()), (type(tm).__name__, t)
            assert _bits(probs(jnp.int32(t))) == _bits(tm.probs(t).numpy())
    jm = jav.MarkovClusters(40, n_clusters=4)
    tm = tav.MarkovClusters(40, n_clusters=4, device="cpu")
    js, ts = jm.init_state(), tm.init_state()
    step = jax.jit(jm.step)
    for jk, tk in _keys(2):
        js, jmask = step(jk, js)
        ts, tmask = tm.step(tk, ts)
        assert _bits(jmask) == _bits(tmask.numpy())
    for fixed, jitter in ((10, 0), (10, 4), (3, 5)):
        jbud, tbud = jav.CommBudget(fixed, jitter), tav.CommBudget(fixed,
                                                                    jitter)
        sample = jax.jit(jbud.sample)
        for t, (jk, tk) in enumerate(_keys(0)):
            assert int(sample(jk, t)) == int(tbud.sample(tk, t))


def test_smartphones_factor_over_a_day():
    """The 24 values of SmartPhones' f_t, XLA's folded phase, ``sin`` and
    FMA, are the jitted JAX process's."""
    jm = jav.SmartPhones(4)
    probs = jax.jit(jm.probs)
    for t in range(48):
        want = np.asarray(probs(jnp.int32(t))) / np.asarray(jm._q)
        np.testing.assert_allclose(tav.smartphones_factor(t), want,
                                   rtol=1e-7)


def test_unknown_axes_raise_key_error():
    for make in (lambda: tp.make_process("nope", 4, device="cpu"),
                 lambda: tb.make_budget("nope", device="cpu"),
                 lambda: tc.make_completion("nope", 4, device="cpu")):
        with pytest.raises(KeyError):
            make()
    with pytest.raises(TypeError):
        tc.make_completion("availability_coupled", 4, device="cpu")
