"""The Shakespeare task (the Table 6 LSTM: vocab 90, 2 × 256 hidden,
sequence 80, 820,522 parameters) end to end under f3ast: the JAX device
engine and the port's engine on the CPU run the same RunSpec JSON (the
``launch.train --task shakespeare`` cell, homedevices availability; 8
sentences a client, a cohort of 4, 3 rounds).  Masks, K_t, |avail| and the
final r_k bitwise; train losses, delta norms and parameters within 1e-5
(measured: 4.8e-7, 4.5e-8, 1.2e-7)."""
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp

ROUNDS = 3


@pytest.fixture(scope="module")
def runs():
    spec = tp.paper_task_spec("shakespeare", "f3ast", ROUNDS,
                              clients_per_round=4)
    with tp.one_intra_op_thread():
        return tp.jax_run(spec, ROUNDS), tp.torch_run(spec, ROUNDS)


def test_selection_bitwise(runs):
    tp.assert_selection_bitwise(*runs)


def test_losses_within_tolerance(runs):
    tp.assert_losses_close(*runs, tp.TOL, tp.TOL)


def test_params_within_tolerance(runs):
    tp.assert_params_close(*runs, tp.TOL)
