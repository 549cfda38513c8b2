"""Every built-in scenario of the JAX package under f3ast, through the
port's engine on the CPU and the JAX device engine: selection and
completion masks, K_t, |avail| and the final r_k bitwise, losses, delta
norms and parameters within 1e-5 (mirrors ``tests/test_parity_matrix.py``
and ``tests/test_sim.py``)."""
import pytest

torch = pytest.importorskip("torch")

import repro.sim as jsim
import repro_torch.sim as tsim
from torch_parity import assert_cell_parity

ROUNDS = 40


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The rounds are small eager ops; several test workers share the
    cores, so each runs on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_is_the_jax_packages():
    assert tsim.list_scenarios() == jsim.list_scenarios()
    for name in jsim.list_scenarios():
        j, t = jsim.get_scenario(name), tsim.get_scenario(name)
        assert tsim.RunSpec(scenario=t).to_json() == \
            jsim.RunSpec(scenario=j).to_json(), name


@pytest.mark.parametrize("scenario", jsim.list_scenarios())
def test_scenario_under_f3ast_matches_jax(scenario):
    # stepk's budget drops at t = 75: run past it
    rounds = 80 if scenario == "stepk" else ROUNDS
    spec = jsim.RunSpec(scenario=scenario, rounds=rounds).to_json()
    k_t, completed = assert_cell_parity(spec, rounds)
    sc = jsim.get_scenario(scenario)
    if sc.budget in ("diurnal", "bandwidth", "step"):
        assert len(set(k_t.tolist())) > 1        # K_t does vary
    if sc.completion != "always":
        assert completed.sum() > 0


@pytest.mark.parametrize("select_impl", ["pallas"])
@pytest.mark.parametrize("scenario", ["diurnal", "straggler"])
def test_fused_cut_gives_the_same_trajectory(scenario, select_impl):
    """``select_impl="pallas"`` (the kernel's plain version on the CPU) is
    bitwise the JAX engine's too, with and without a completion hook."""
    spec = jsim.RunSpec(scenario=scenario, rounds=20,
                        select_impl=select_impl).to_json()
    assert_cell_parity(spec, 20)
