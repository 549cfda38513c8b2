"""Shared helper of the engine parity tests: one RunSpec JSON through the
JAX device engine and through the port's engine on the CPU, chunk by
chunk as ``run_scenario_device`` runs them, returning what the bitwise
contract and the 1e-5 tolerance compare."""
import jax
import jax.numpy as jnp
import numpy as np

import repro.sim as jsim
from repro.core.strategies import strategy_rates
from repro.sim.engine import _unpack_stream
from repro.sim.engine import build_engine as jax_build_engine
from repro_torch import random as tr
from repro_torch.sim import RunSpec as TorchRunSpec
from repro_torch.sim.engine import build_engine as torch_build_engine

TOL = 1e-5
CHUNK = 10


def _engine_kwargs(rs):
    return dict(seed=rs.seed, clients_per_round=rs.clients_per_round,
                beta=rs.beta, server_opt=rs.server_opt,
                server_lr=rs.server_lr, prox_mu=rs.prox_mu,
                positively_correlated=rs.positively_correlated,
                strategy_kwargs=rs.strategy_kwargs,
                completion=rs.completion,
                completion_kwargs=rs.completion_kwargs,
                select_impl=rs.select_impl)


def _jax_run(spec_json, rounds):
    rs = jsim.RunSpec.from_json(spec_json).resolved()
    eng, _ = jax_build_engine(rs.scenario, rs.strategy,
                              **_engine_kwargs(rs))
    carry = eng.init_carry(jax.random.PRNGKey(rs.seed))
    outs = []
    for t0 in range(0, rounds, CHUNK):
        ts = jnp.arange(t0, min(t0 + CHUNK, rounds), dtype=jnp.int32)
        carry, out = eng.chunk(carry, ts)
        outs.append(_unpack_stream(jax.tree.map(np.asarray, out),
                                   eng.n_clients))
    r = strategy_rates(eng.strategy, carry.algo_state)
    return outs, {k: np.asarray(v) for k, v in carry.params.items()}, \
        np.asarray(r)


def _torch_run(spec_json, rounds):
    rs = TorchRunSpec.from_json(spec_json).resolved()
    eng, _ = torch_build_engine(rs.scenario, rs.strategy, device="cpu",
                                **_engine_kwargs(rs))
    carry = eng.init_carry(tr.PRNGKey(rs.seed, device="cpu"))
    outs = []
    for t0 in range(0, rounds, CHUNK):
        carry, out = eng.chunk(carry, range(t0, min(t0 + CHUNK, rounds)))
        outs.append([x.numpy() for x in out])
    return outs, {k: v.detach().numpy() for k, v in carry.params.items()}, \
        carry.algo_state.rates.r.numpy()


def assert_cell_parity(spec_json, rounds):
    """Masks, completed masks, K_t, |avail| and the final r_k bitwise;
    train loss, delta norm and the final parameters within TOL."""
    j_outs, j_params, j_r = _jax_run(spec_json, rounds)
    t_outs, t_params, t_r = _torch_run(spec_json, rounds)

    def cat(outs, i):
        return np.concatenate([o[i] for o in outs])

    names = ("sel_mask", "completed", "k_t", "n_available")
    for i, name in enumerate(names):
        want, got = cat(j_outs, i), cat(t_outs, i)
        assert want.shape == got.shape, name
        assert want.astype(got.dtype).tobytes() == got.tobytes(), name
    assert j_r.dtype == t_r.dtype == np.float32
    assert j_r.tobytes() == t_r.tobytes(), "final r_k"
    for i, name in ((4, "train_loss"), (5, "delta_norm")):
        np.testing.assert_allclose(cat(t_outs, i), cat(j_outs, i), rtol=0,
                                   atol=TOL, err_msg=name)
    assert sorted(j_params) == sorted(t_params)
    for k in j_params:
        np.testing.assert_allclose(t_params[k], j_params[k], rtol=0,
                                   atol=TOL, err_msg=k)
    assert np.isfinite(cat(t_outs, 4)).all()
    return cat(t_outs, 2), cat(t_outs, 1)
