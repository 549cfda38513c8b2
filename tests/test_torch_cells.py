"""``run_cells_vmapped`` of the port: a batch of (seed × budget-cap) cells
over one data realisation, held to the JAX package's vmapped program —
selection masks bitwise, train loss within 1e-5 — and each cell to the
port's single-cell run at its seed and cap (``DeviceEngine.chunk`` with
``k_cap``), bitwise."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro.sim as jsim
import repro_torch.sim as tsim
from repro_torch import random as tr
from repro_torch.sim.engine import _to_host, build_engine
from torch_parity import one_intra_op_thread

ROUNDS = 16
CASES = {"seeds": dict(seeds=[0, 1], k_caps=None),
         "caps": dict(seeds=[0, 0], k_caps=[3, 10])}


@pytest.fixture(scope="module")
def runs():
    out = {}
    with one_intra_op_thread():
        for name, kw in CASES.items():
            out[name] = (
                jsim.run_cells_vmapped("scarce", "f3ast", rounds=ROUNDS,
                                       chunk_size=8, **kw),
                tsim.run_cells_vmapped("scarce", "f3ast", rounds=ROUNDS,
                                       chunk_size=8, device="cpu", **kw))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_cells_match_jax_vmapped(runs, case):
    j, t = runs[case]
    assert sorted(t) == sorted(j)
    assert t["seeds"] == j["seeds"] and t["k_caps"] == j["k_caps"]
    assert t["rounds"] == j["rounds"] == ROUNDS
    assert t["sel_history"].shape == (2, ROUNDS, 100)
    assert t["sel_history"].tobytes() == j["sel_history"].tobytes()
    assert t["comp_history"].tobytes() == j["comp_history"].tobytes()
    np.testing.assert_allclose(t["train_loss"], j["train_loss"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(t["rates"], j["rates"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t["test_loss"], j["test_loss"], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(t["empirical_rates"], j["empirical_rates"])


def test_caps_bound_selection(runs):
    _, t = runs["caps"]
    assert t["sel_history"][0].sum(axis=1).max() <= 3
    assert t["sel_history"][1].sum(axis=1).max() > 3
    _, t = runs["seeds"]
    assert not np.array_equal(t["sel_history"][0], t["sel_history"][1])


@pytest.mark.parametrize("cell", [0, 1])
def test_each_cell_is_its_single_cell_run(runs, cell):
    """Cell i of the "caps" batch is the device engine's run at seed 0 and
    cap k_caps[i], chunk by chunk: masks and final r_k bitwise."""
    _, t = runs["caps"]
    engine, _ = build_engine("scarce", "f3ast", device="cpu", seed=0)
    carry = engine.init_carry(tr.PRNGKey(0, device="cpu"))
    masks = []
    with one_intra_op_thread():
        for t0 in range(0, ROUNDS, 8):
            carry, out = engine.chunk(carry, range(t0, t0 + 8),
                                      k_cap=t["k_caps"][cell])
            masks.append(_to_host(out, engine.n_clients).sel_mask)
    assert np.concatenate(masks).tobytes() == \
        t["sel_history"][cell].tobytes()
    assert carry.algo_state.rates.r.numpy().tobytes() == \
        t["rates"][cell].tobytes()
