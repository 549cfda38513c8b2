"""Shared helper of the engine parity tests: one RunSpec JSON through the
JAX device engine and through the port's engine on the CPU, chunk by
chunk as ``run_scenario_device`` runs them (``jax_run``, ``torch_run``:
the per-round streams, the final parameters' leaves in JAX's order and
the final r_k), and the checks of the bitwise contract and the
tolerances on them."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.sim as jsim
from repro.core.strategies import strategy_rates
from repro.sim.engine import _unpack_stream
from repro.sim.engine import build_engine as jax_build_engine
from repro_torch import random as tr
from repro_torch.convert import params_to_numpy
from repro_torch.sim import RunSpec as TorchRunSpec
from repro_torch.sim.engine import _to_host
from repro_torch.sim.engine import build_engine as torch_build_engine
from repro_torch.tree import tree_leaves

TOL = 1e-5
CHUNK = 10
# the paper tasks' data cut for the CPU (the models stay at the task
# configs): 8 sentences a client; 8x8 images, 20 a class
REDUCED_TASK_KWARGS = {"shakespeare": {"sentences_per_client": 8},
                       "cifar": {"img": 8, "per_class": 20}}


@contextlib.contextmanager
def one_intra_op_thread():
    """Several test workers share the cores, so a run takes one intra-op
    thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def paper_task_spec(task, strategy, rounds, **spec_kw):
    """The RunSpec JSON of the cell ``launch.train --task <task>`` builds
    (availability ``homedevices``), with the data cut by
    ``REDUCED_TASK_KWARGS``."""
    sc = jsim.Scenario(name="homedevices", availability="homedevices",
                       task=task, task_kwargs=REDUCED_TASK_KWARGS[task])
    return jsim.RunSpec(scenario=sc, strategy=strategy, rounds=rounds,
                        **spec_kw).to_json()


def _engine_kwargs(rs):
    return dict(seed=rs.seed, clients_per_round=rs.clients_per_round,
                beta=rs.beta, server_opt=rs.server_opt,
                server_lr=rs.server_lr, prox_mu=rs.prox_mu,
                positively_correlated=rs.positively_correlated,
                strategy_kwargs=rs.strategy_kwargs,
                completion=rs.completion,
                completion_kwargs=rs.completion_kwargs,
                select_impl=rs.select_impl, fed_mode=rs.fed_mode)


def jax_run(spec_json, rounds, chunk=CHUNK, history=None):
    """JAX's run; with a ``history`` list, each chunk appends the
    parameters' leaves and the server optimizer's first moments (``m``,
    where it has them) after it."""
    rs = jsim.RunSpec.from_json(spec_json).resolved()
    eng, _ = jax_build_engine(rs.scenario, rs.strategy,
                              **_engine_kwargs(rs))
    carry = eng.init_carry(jax.random.PRNGKey(rs.seed))
    outs = []
    for t0 in range(0, rounds, chunk):
        ts = jnp.arange(t0, min(t0 + chunk, rounds), dtype=jnp.int32)
        carry, out = eng.chunk(carry, ts)
        outs.append(_unpack_stream(jax.tree.map(np.asarray, out),
                                   eng.n_clients))
        if history is not None:
            m = getattr(carry.opt_state, "m", None)
            history.append(dict(
                params=[np.asarray(x) for x in jax.tree.leaves(carry.params)],
                m=None if m is None else [np.asarray(x)
                                          for x in jax.tree.leaves(m)]))
    r = strategy_rates(eng.strategy, carry.algo_state)
    return outs, [np.asarray(x) for x in jax.tree.leaves(carry.params)], \
        np.asarray(r)


def torch_run(spec_json, rounds, chunk=CHUNK, history=None):
    """The port's run on the CPU; ``history`` as in :func:`jax_run`."""
    rs = TorchRunSpec.from_json(spec_json).resolved()
    eng, _ = torch_build_engine(rs.scenario, rs.strategy, device="cpu",
                                **_engine_kwargs(rs))
    carry = eng.init_carry(tr.PRNGKey(rs.seed, device="cpu"))
    outs = []
    for t0 in range(0, rounds, chunk):
        carry, out = eng.chunk(carry, range(t0, min(t0 + chunk, rounds)))
        outs.append(list(_to_host(out, eng.n_clients)))
        if history is not None:
            m = getattr(carry.opt_state, "m", None)
            history.append(dict(
                params=tree_leaves(params_to_numpy(carry.params)),
                m=None if m is None else tree_leaves(params_to_numpy(m))))
    # leaves in JAX's order, so they pair with _jax_run's by position
    return outs, tree_leaves(params_to_numpy(carry.params)), \
        carry.algo_state.rates.r.numpy()


def _cat(outs, i):
    return np.concatenate([o[i] for o in outs])


def assert_selection_bitwise(jax_run, torch_run):
    """Masks, completed masks, K_t, |avail| and the final r_k bitwise."""
    (j_outs, _, j_r), (t_outs, _, t_r) = jax_run, torch_run
    names = ("sel_mask", "completed", "k_t", "n_available")
    for i, name in enumerate(names):
        want, got = _cat(j_outs, i), _cat(t_outs, i)
        assert want.shape == got.shape, name
        assert want.astype(got.dtype).tobytes() == got.tobytes(), name
    assert j_r.dtype == t_r.dtype == np.float32
    assert j_r.tobytes() == t_r.tobytes(), "final r_k"


def assert_losses_close(jax_run, torch_run, loss_tol, dnorm_tol):
    """Train loss within ``loss_tol`` and delta norm within ``dnorm_tol``
    each round; the port's losses finite."""
    j_outs, t_outs = jax_run[0], torch_run[0]
    np.testing.assert_allclose(_cat(t_outs, 4), _cat(j_outs, 4), rtol=0,
                               atol=loss_tol, err_msg="train_loss")
    np.testing.assert_allclose(_cat(t_outs, 5), _cat(j_outs, 5), rtol=0,
                               atol=dnorm_tol, err_msg="delta_norm")
    assert np.isfinite(_cat(t_outs, 4)).all()


def assert_round_one_delta_norm_close(jax_run, torch_run, tol):
    """Round 1's delta norm (both sides start from the same weights)
    within ``tol``."""
    np.testing.assert_allclose(_cat(torch_run[0], 5)[0],
                               _cat(jax_run[0], 5)[0], rtol=0, atol=tol,
                               err_msg="round-1 delta_norm")


def assert_params_close(jax_run, torch_run, tol):
    """The final parameters (nested trees included, leaf by leaf in JAX's
    order) within ``tol``."""
    j_params, t_params = jax_run[1], torch_run[1]
    assert len(j_params) == len(t_params)
    for i, (want, got) in enumerate(zip(j_params, t_params)):
        assert want.shape == got.shape, f"leaf {i}"
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=f"leaf {i}")


def assert_cell_parity(spec_json, rounds):
    """Masks, completed masks, K_t, |avail| and the final r_k bitwise;
    train loss, delta norm and the final parameters within TOL."""
    j, t = jax_run(spec_json, rounds), torch_run(spec_json, rounds)
    assert_selection_bitwise(j, t)
    assert_losses_close(j, t, TOL, TOL)
    assert_params_close(j, t, TOL)
    return _cat(t[0], 2), _cat(t[0], 1)


def assert_first_round_params_close(jax_history, torch_history, b1, floor,
                                    tol, min_kept):
    """After round 1 of a server-Adam run (histories of ``chunk=1`` runs):
    the parameters within ``tol`` on the coordinates whose JAX Δ_1
    (``m_1 / (1 - b1)``) exceeds ``floor`` in magnitude, which must be at
    least ``min_kept`` of them.  Returns (kept share, coordinates with Δ_1
    exactly 0, within 1e-8 of 0), and prints them."""
    d1 = np.concatenate([m.ravel() for m in jax_history[0]["m"]]) / (1 - b1)
    keep = np.abs(d1) > floor
    want = np.concatenate([x.ravel() for x in jax_history[0]["params"]])
    got = np.concatenate([x.ravel() for x in torch_history[0]["params"]])
    stats = (float(keep.mean()), int((d1 == 0).sum()),
             int((np.abs(d1) <= 1e-8).sum()))
    print(f"round 1: |Δ_1| > {floor} on {stats[0]:.4f} of {d1.size}; "
          f"Δ_1 == 0 on {stats[1]}, |Δ_1| <= 1e-8 on {stats[2]}; "
          f"max |Δparams| kept {np.abs(got - want)[keep].max():.3g}, "
          f"all {np.abs(got - want).max():.3g}")
    assert stats[0] >= min_kept, stats
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=tol,
                               err_msg="round-1 parameters, clear Δ_1")
    return stats
