"""The port's device engine on on-demand client data (a ``SynthTask``)
against the JAX package's: the N-scaling cell of
``benchmarks/bench_engine.py::_build_nscale_engine`` (bernoulli q = 0.3,
K = 10, f3ast, softmax regression, E = 5, B = 20) at N = 300 and 4,099,
20 rounds.  Masks, completed masks, K_t, |avail| and the final r_k bitwise
JAX's; train loss and delta norm within 1e-5.  The staged
(``stage_synth_task``) and synthesized engines of the port are bitwise
each other, losses included, and the synthesized one keeps 0 bytes
resident."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.fedstep import make_fed_round as jax_make_fed_round
from repro.core.strategies import make_strategy as jax_make_strategy
from repro.data.synthetic import SynthTask as JaxSynthTask
from repro.models import softmax_reg as jax_softmax
from repro.optim import make_optimizer as jax_make_optimizer
from repro.sim.budgets import make_budget as jax_make_budget
from repro.sim.engine import DeviceEngine as JaxDeviceEngine
from repro.sim.engine import _unpack_stream as jax_unpack
from repro.sim.processes import make_process as jax_make_process
from repro_torch import random as tr
from repro_torch.core.fedstep import make_fed_round
from repro_torch.data import SynthTask, stage_synth_task
from repro_torch.sim.engine import DeviceEngine, _to_host

import torch_dist_workers as workers
from torch_parity import one_intra_op_thread

ROUNDS, K, TOL = 20, 10, 1e-5
FIELDS = ("sel_mask", "completed", "k_t", "n_available")


@pytest.fixture(autouse=True)
def _one_thread():
    """Test workers share the cores: one intra-op thread a test."""
    with one_intra_op_thread():
        yield


def _jax_run(n, seed):
    cfg = jax_softmax.SoftmaxRegConfig(dim=32, n_classes=10)
    loss = functools.partial(jax_softmax.loss_fn, cfg)
    opt = jax_make_optimizer("sgd", lr=1.0)
    eng = JaxDeviceEngine(
        avail_model=jax_make_process("bernoulli", n, q=0.3),
        budget=jax_make_budget("constant", k=K),
        strategy=jax_make_strategy("f3ast", n,
                                   np.full(n, 1.0 / n, np.float32),
                                   clients_per_round=K),
        staged=JaxSynthTask(n_clients=n, seed=seed),
        fed_round=jax_make_fed_round(loss, opt),
        init_params=functools.partial(jax_softmax.init_params, cfg),
        opt=opt, client_lr=0.05, local_steps=5, local_batch=20)
    carry = eng.init_carry(jax.random.PRNGKey(0))
    carry, out = eng.chunk(carry, jnp.arange(ROUNDS, dtype=jnp.int32))
    assert eng.n_staged_bytes == 0
    return (jax_unpack(jax.tree.map(np.asarray, out), n),
            np.asarray(carry.algo_state.rates.r))


def _torch_run(n, staged):
    parts = workers.engine_parts(n, K)
    parts["fed_round"] = make_fed_round(parts.pop("loss"), parts["opt"])
    eng = DeviceEngine(staged=staged, device="cpu", **parts)
    carry = eng.init_carry(tr.PRNGKey(0, device="cpu"))
    carry, out = eng.chunk(carry, range(ROUNDS))
    return eng, _to_host(out, n), carry.algo_state.rates.r.numpy()


@pytest.mark.parametrize("n,seed", [(300, 3), (4099, 0)])
def test_synth_engine_bitwise_jax_and_staged(n, seed):
    task = SynthTask(n_clients=n, seed=seed)
    want, want_r = _jax_run(n, seed)
    eng, got, got_r = _torch_run(n, task)
    assert eng.n_staged_bytes == 0 and eng.n_clients == n
    for name in FIELDS:
        w, g = getattr(want, name), getattr(got, name)
        assert w.shape == g.shape, name
        assert w.astype(g.dtype).tobytes() == g.tobytes(), name
    assert got.sel_mask.shape == (ROUNDS, n)
    assert (got.sel_mask.sum(1) == np.minimum(got.k_t,
                                              got.n_available)).all()
    assert want_r.tobytes() == got_r.tobytes()
    np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got.delta_norm, want.delta_norm, rtol=0,
                               atol=TOL)
    staged = stage_synth_task(task, "cpu")
    s_eng, s_got, s_r = _torch_run(n, staged)
    assert s_eng.n_staged_bytes == n * task.bytes_per_client + 4 * n
    for name in FIELDS + ("train_loss", "delta_norm"):
        assert getattr(s_got, name).tobytes() == \
            getattr(got, name).tobytes(), name
    assert s_r.tobytes() == got_r.tobytes()
