"""A strategy registered with ``rates_of`` reports its rates in both
packages: ``strategy_rates`` reads them through ``rates_of`` when it is
set, and falls back to the built-in ``state.rates.r``.  A state that is
not ``RateTrackState`` (here a bare tuple ``(r,)``) has no ``.rates.r``,
so without ``rates_of`` no rates would be reported."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import strategies as jstrat  # noqa: E402
from repro_torch.core import strategies as tstrat  # noqa: E402
from repro_torch import random as jr  # noqa: E402

N = 12
R0 = np.linspace(0.05, 0.6, N).astype(np.float32)


def _jax_toy():
    return jstrat.topk_strategy(
        "toy", init=lambda n_clients=N, r0=None: (jnp.asarray(R0),),
        score=lambda s, key, avail, k, ctx=None: s[0],
        finalize=lambda s, mask, ctx=None: (mask.astype(jnp.float32),
                                            (s[0] * 0.5 + mask * 0.5,)),
        n_clients=N, rates_of=lambda s: s[0])


def _torch_toy():
    return tstrat.topk_strategy(
        "toy", init=lambda n_clients=N, r0=None: (torch.from_numpy(R0),),
        score=lambda s, key, avail, k, ctx=None: s[0],
        finalize=lambda s, mask, ctx=None: (mask.to(torch.float32),
                                            (s[0] * 0.5 + mask * 0.5,)),
        n_clients=N, rates_of=lambda s: s[0], device="cpu")


def test_strategy_rates_uses_rates_of_as_jax_does():
    js, ts = _jax_toy(), _torch_toy()
    jstate, tstate = js.init(), ts.init()
    assert ts.rates_of is not None
    want = np.asarray(jstrat.strategy_rates(js, jstate))
    got = tstrat.strategy_rates(ts, tstate)
    assert got is not None and got.numpy().tobytes() == want.tobytes()
    # and after a round, through each package's select
    avail = np.arange(N) % 3 != 0
    jmask, _, jstate = js.select(jstate, jax.random.PRNGKey(0),
                                 jnp.asarray(avail), jnp.asarray(4))
    tmask, _, tstate = ts.select(tstate, jr.PRNGKey(0, device="cpu"),
                                 torch.from_numpy(avail), 4)
    assert tmask.numpy().tobytes() == np.asarray(jmask).tobytes()
    want = np.asarray(jstrat.strategy_rates(js, jstate))
    got = tstrat.strategy_rates(ts, tstate)
    assert got.numpy().tobytes() == want.tobytes()


def test_strategy_rates_falls_back_to_the_rate_ema():
    s = tstrat.make_strategy("f3ast", N, np.full(N, 1.0 / N), device="cpu")
    assert s.rates_of is None
    state = s.init(r0=0.25)
    assert torch.equal(tstrat.strategy_rates(s, state), state.rates.r)
    # a strategy without rates_of whose state has no .rates reports None
    bare = _torch_toy()._replace(rates_of=None)
    assert tstrat.strategy_rates(bare, bare.init()) is None


def test_topk_strategy_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tstrat.topk_strategy("toy", init=None, score=None, finalize=None)
