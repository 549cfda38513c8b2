"""The port's federated round vs the JAX package's, from the same weights
(carried across with ``repro_torch.convert``) on the same batch and
aggregation weights: params, loss and delta norm within 1e-5 after 1 and
after 5 rounds (float sums are taken in other orders, so not bitwise)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.fedstep import make_fed_round as jmake_fed_round
from repro.models import softmax_reg as jsr
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.fedstep import make_fed_round as tmake_fed_round
from repro_torch.models import softmax_reg as tsr
from repro_torch.optim import make_optimizer as tmake_optimizer

TOL = 1e-5
K, E, B, DIM, C = 10, 5, 20, 60, 10


def _weights(seed):
    rng = np.random.default_rng(seed)
    return {"w": (0.1 * rng.normal(size=(DIM, C))).astype(np.float32),
            "b": (0.1 * rng.normal(size=(C,))).astype(np.float32)}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(K, E, B, DIM)).astype(np.float32),
            "y": rng.integers(0, C, size=(K, E, B)).astype(np.int32)}


def _agg_weights(seed):
    rng = np.random.default_rng(seed)
    w = (rng.random(K) * 2).astype(np.float32)
    w[8:] = 0.0                        # padded cohort slots
    return w


@pytest.mark.parametrize("rounds", [1, 5])
@pytest.mark.parametrize("prox_mu", [0.0, 0.1])
def test_fed_round_matches_jax(rounds, prox_mu):
    jcfg, tcfg = jsr.SoftmaxRegConfig(), tsr.SoftmaxRegConfig()
    jround = jax.jit(jmake_fed_round(functools.partial(jsr.loss_fn, jcfg),
                                     jmake_optimizer("sgd", lr=1.0),
                                     prox_mu=prox_mu))
    topt = tmake_optimizer("sgd", lr=1.0)
    tround = tmake_fed_round(functools.partial(tsr.loss_fn, tcfg), topt,
                             prox_mu=prox_mu)
    p0 = _weights(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = params_from_numpy(p0, device="cpu")
    assert all(params_to_numpy(tp)[k].tobytes() == p0[k].tobytes()
               for k in p0)
    jstate = jmake_optimizer("sgd", lr=1.0).init(jp)
    tstate = topt.init(tp)
    for t in range(rounds):
        batch, w = _batch(10 + t), _agg_weights(20 + t)
        jp, jstate, jm = jround(jp, jstate,
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                jnp.asarray(w), jnp.asarray(0.01, jnp.float32))
        tp, tstate, tm = tround(tp, tstate,
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                                torch.from_numpy(w), 0.01)
        np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(float(tm.delta_norm), float(jm.delta_norm),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(float(tm.grad_norm), float(jm.grad_norm),
                                   rtol=0, atol=TOL)
    got = params_to_numpy(tp)
    for k in p0:
        np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=0,
                                   atol=TOL)


def test_loss_and_accuracy_match_jax():
    p0 = _weights(1)
    rng = np.random.default_rng(2)
    batch = {"x": rng.normal(size=(64, DIM)).astype(np.float32),
             "y": rng.integers(0, C, size=64).astype(np.int32)}
    jcfg, tcfg = jsr.SoftmaxRegConfig(), tsr.SoftmaxRegConfig()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tp = params_from_numpy(p0, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    np.testing.assert_allclose(float(tsr.loss_fn(tcfg, tp, tb)),
                               float(jsr.loss_fn(jcfg, jp, jb)), atol=TOL)
    assert float(tsr.accuracy(tcfg, tp, tb)) == \
        float(jsr.accuracy(jcfg, jp, jb))


def test_sequential_mode_is_not_ported():
    with pytest.raises(NotImplementedError):
        tmake_fed_round(functools.partial(tsr.loss_fn,
                                          tsr.SoftmaxRegConfig()),
                        tmake_optimizer("sgd"), mode="sequential")
