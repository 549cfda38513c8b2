"""The CIFAR task end to end under fedadam (FedAvg selection with a
server Adam step, lr 1e-2): the port's engine on the CPU in its default
``parallel`` mode against the JAX device engine in ``fed_mode=
"sequential"``, the same RunSpec otherwise, run a round at a time.  JAX's
own parallel mode is not the reference here: its vmapped convolution
gradient is 5.4e-4 off float64's (see ``test_torch_task_cifar.py``), and
Adam's first step turns that into sign flips of ±lr (measured 2.0e-2
after round 1); the port's parallel mode matches JAX's sequential mode
within 2.4e-7 under f3ast.

Masks, K_t, |avail| and the final r_k bitwise.  Round 1's delta norm
within 1e-5 (measured 1.2e-7), and the parameters after its Adam step
within 1e-5 on the coordinates whose JAX Δ_1 exceeds 1e-6 (measured
44.0% of 310,116, within 8.3e-7).  Of the rest, 172,418 have Δ_1
exactly 0 (the last stage's 3×3 convolutions see 2×2 and 1×1 maps of
the 8×8 images, so most taps read SAME padding), which Adam leaves at
0 on both sides.  After that Adam amplifies rounding as in
``test_torch_task_shakespeare_fedadam.py``: measured after 3 rounds,
train loss 2.4e-3, delta norm 2.5e-4, parameters 1.4e-2.  Held: train
loss within 1e-2, delta norm within 1e-2, final parameters within
3e-2."""
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp

ROUNDS = 3
LOSS_TOL = 1e-2
DNORM_TOL = 1e-2
PARAM_TOL = 3e-2
ADAM_B1 = 0.9
DELTA_FLOOR = 1e-6      # 100 × Δ's rounding error
MIN_KEPT = 0.4


@pytest.fixture(scope="module")
def runs():
    jh, th = [], []
    with tp.one_intra_op_thread():
        j = tp.jax_run(tp.paper_task_spec("cifar", "fedadam", ROUNDS,
                                          fed_mode="sequential"),
                       ROUNDS, chunk=1, history=jh)
        t = tp.torch_run(tp.paper_task_spec("cifar", "fedadam", ROUNDS),
                         ROUNDS, chunk=1, history=th)
    return j, t, jh, th


def test_selection_bitwise(runs):
    tp.assert_selection_bitwise(*runs[:2])


def test_losses_within_tolerance(runs):
    j, t = runs[:2]
    tp.assert_losses_close(j, t, LOSS_TOL, DNORM_TOL)
    tp.assert_round_one_delta_norm_close(j, t, tp.TOL)


def test_params_within_tolerance(runs):
    j, t, jh, th = runs
    tp.assert_first_round_params_close(jh, th, ADAM_B1, DELTA_FLOOR, tp.TOL,
                                       MIN_KEPT)
    tp.assert_params_close(j, t, PARAM_TOL)
