"""The CIFAR task (ResNet-18 topology with GroupNorm at the task config:
width 16, stages (1, 1, 1, 1), 20 classes, 310,116 parameters) end to
end under f3ast: one RunSpec JSON (the ``launch.train --task cifar``
cell, homedevices availability; 8×8 images, 20 a class, 3 rounds)
through the JAX device engine and the port's engine on the CPU, in both
cohort modes.

Masks, K_t, |avail| and the final r_k bitwise in every pairing.  The
port in either mode is within 1e-5 of JAX's ``fed_mode="sequential"``
(train loss, delta norm, parameters; measured 2.4e-7).  JAX's default
``parallel`` mode is not: XLA:CPU's convolution gradient under ``vmap``
(per-client weights) departs from the float64 gradient by up to 5.4e-4
where the unbatched one stays within 4e-7, so JAX's two modes differ by
6.1e-3 in train loss and 6.0e-3 in parameters after 3 rounds, and the
port's parallel mode (its gradient within 5.1e-7 of float64's) differs
from JAX's parallel mode by the same.  Held there: 1e-2."""
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp

ROUNDS = 3
JAX_PARALLEL_TOL = 1e-2


@pytest.fixture(scope="module")
def runs():
    par = tp.paper_task_spec("cifar", "f3ast", ROUNDS)
    seq = tp.paper_task_spec("cifar", "f3ast", ROUNDS, fed_mode="sequential")
    with tp.one_intra_op_thread():
        return {"jax_parallel": tp.jax_run(par, ROUNDS),
                "jax_sequential": tp.jax_run(seq, ROUNDS),
                "parallel": tp.torch_run(par, ROUNDS),
                "sequential": tp.torch_run(seq, ROUNDS)}


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_selection_bitwise(runs, mode):
    tp.assert_selection_bitwise(runs["jax_parallel"], runs[mode])
    tp.assert_selection_bitwise(runs["jax_sequential"], runs[mode])


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_matches_jax_sequential(runs, mode):
    tp.assert_losses_close(runs["jax_sequential"], runs[mode], tp.TOL,
                           tp.TOL)
    tp.assert_params_close(runs["jax_sequential"], runs[mode], tp.TOL)


def test_jax_parallel_within_its_own_mode_gap(runs):
    """The port's parallel run against JAX's parallel run, and JAX's two
    modes against each other: both within JAX_PARALLEL_TOL."""
    for a, b in (("jax_parallel", "parallel"),
                 ("jax_parallel", "jax_sequential")):
        tp.assert_losses_close(runs[a], runs[b], JAX_PARALLEL_TOL,
                               JAX_PARALLEL_TOL)
        tp.assert_params_close(runs[a], runs[b], JAX_PARALLEL_TOL)
