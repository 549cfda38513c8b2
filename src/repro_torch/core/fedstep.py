"""The federated round (port of ``repro.core.fedstep``, ``parallel`` mode).

A round (paper Algorithm 1 lines 6-10) takes the global model w̄^t, runs E
local SGD steps for every client of the cohort, aggregates the weighted
deltas Δ^{t+1} = Σ_k w_k v_k, and applies SERVEROPT.  The cohort axis is
batched with ``torch.func.vmap`` over ``torch.func.grad_and_value`` of the
loss; the Δ reduction is ``kernels.fed_aggregate`` over the whole parameter
dict flattened into one (K, D) buffer (the CUDA kernel on the card, its
plain version on the CPU).  The weights are computed outside, so one round
function serves every strategy.

Batch layout: every leaf of ``cohort_batch`` has shape (K, E, B, ...).
``sequential`` mode is ROADMAP.md queue 1 item 5.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import grad_and_value, vmap

from ..kernels.fed_aggregate import fed_aggregate_tree
from ..optim.optimizers import Optimizer, apply_updates


class RoundMetrics(NamedTuple):
    loss: torch.Tensor          # mean local loss over cohort & local steps
    delta_norm: torch.Tensor    # ||Delta||_2
    grad_norm: torch.Tensor     # mean per-step grad norm


def _sq_norm(tree: dict) -> torch.Tensor:
    """Σ over leaves of Σ x², leaves in sorted-key order (jax.tree order)."""
    return sum(torch.sum(tree[k] * tree[k]).to(torch.float32)
               for k in sorted(tree))


def _local_sgd(loss_fn: Callable, params: dict, client_batch: dict,
               lr: float, prox_mu: float = 0.0):
    """E local SGD steps for one client; returns (v_k, mean_loss,
    mean_gnorm).  ``client_batch`` leaves have shape (E, B, ...).

    ``prox_mu > 0`` adds the FedProx proximal gradient mu·(w − w̄).  The
    step ``w − lr·g`` is spelled ``add(alpha=−lr)`` (one rounding, as the
    jitted JAX step is FMA-contracted).
    """
    vg = grad_and_value(loss_fn)
    n_steps = next(iter(client_batch.values())).shape[0]
    w = params
    losses, gnorms = [], []
    for e in range(n_steps):
        g, loss = vg(w, {k: v[e] for k, v in client_batch.items()})
        if prox_mu > 0.0:
            g = {k: g[k] + prox_mu * (w[k] - params[k]) for k in g}
        gnorms.append(torch.sqrt(_sq_norm(g)))
        losses.append(loss)
        w = {k: torch.add(w[k], g[k], alpha=-lr) for k in w}
    v_k = {k: w[k] - params[k] for k in w}
    return v_k, torch.stack(losses).mean(), torch.stack(gnorms).mean()


def make_fed_round(loss_fn: Callable, server_opt: Optimizer, *,
                   mode: str = "parallel", prox_mu: float = 0.0):
    """Build the round function

        fed_round(params, opt_state, cohort_batch, weights, client_lr)
            -> (params, opt_state, RoundMetrics)

    ``client_lr`` is a Python float (folded into the step as float32).
    """
    if mode != "parallel":
        raise NotImplementedError(
            f"fed_mode={mode!r} is not ported to repro_torch yet (ROADMAP.md "
            f"queue 1 item 5); ported: 'parallel'")

    def fed_round(params, opt_state, cohort_batch, weights, client_lr):
        deltas, losses, gnorms = vmap(
            lambda b: _local_sgd(loss_fn, params, b, float(client_lr),
                                 prox_mu))(cohort_batch)
        delta = fed_aggregate_tree(deltas, weights.to(torch.float32))
        dnorm = torch.sqrt(_sq_norm(delta))
        updates, opt_state = server_opt.update(delta, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, RoundMetrics(loss=losses.mean(),
                                               delta_norm=dnorm,
                                               grad_norm=gnorms.mean())

    return fed_round
