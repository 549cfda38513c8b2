"""The federated round (port of ``repro.core.fedstep``).

A round (paper Algorithm 1 lines 6-10) takes the global model w̄^t, runs E
local SGD steps for every client of the cohort, aggregates the weighted
deltas Δ^{t+1} = Σ_k w_k v_k, and applies SERVEROPT.  The weights are
computed outside, so one round function serves every strategy.  The
parameters are a tree of nested dicts and lists (``repro_torch.tree``).

Two cohort execution modes, as in the JAX package:

* ``parallel``   — the cohort axis is batched with ``torch.func.vmap`` over
                   ``torch.func.grad_and_value`` of the loss; the Δ
                   reduction is ONE ``kernels.fed_aggregate`` call over the
                   whole tree flattened into a (K, D) buffer (the CUDA
                   kernel on the card, its plain version on the CPU).
                   Memory ≈ K local model copies.
* ``sequential`` — a loop over the cohort; each client's weighted delta is
                   added to a float32 accumulator (``streaming_aggregate_add``)
                   and no ``fed_aggregate`` runs.  Memory ≈ 3 model copies,
                   whatever the cohort size.

Batch layout: every leaf of ``cohort_batch`` has shape (K, E, B, ...).

With ``cohort_axis`` (a ``launch.mesh.ClientMesh``) the round is the
client-sharded engine's: each shard trains its slice of the cohort slots,
reduces its weighted deltas with one ``fed_aggregate`` call and sums the
shards' Δ with one ``all_reduce`` (JAX's ``psum``).  With ``model_axis``
too (the model axis of the (clients, model) mesh) the parameters and the
server optimizer's state are stored as this rank's blocks: the round
gathers them to full width, trains, and keeps its block of Δ.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.func import grad_and_value, vmap

from ..kernels.fed_aggregate import fed_aggregate, fed_aggregate_tree
from ..optim.optimizers import Optimizer, apply_updates
from ..remat import checkpoint
from ..sharding.rules import (gather_full, local_blocks, model_dim,
                              specs_up_to)
from ..tree import tree_leaves, tree_map, tree_unflatten
from .aggregation import streaming_aggregate_add, streaming_aggregate_init


class RoundMetrics(NamedTuple):
    loss: torch.Tensor          # mean local loss over cohort & local steps
    delta_norm: torch.Tensor    # ||Delta||_2
    grad_norm: torch.Tensor     # mean per-step grad norm


def _sq_norm(tree) -> torch.Tensor:
    """Σ over leaves of Σ x², leaves in JAX's order."""
    return sum(torch.sum(x * x).to(torch.float32) for x in tree_leaves(tree))


def _rematted(loss_fn: Callable) -> Callable:
    """``loss_fn(params, batch)`` whose activations are recomputed in the
    backward instead of kept (:func:`repro_torch.remat.checkpoint`); the
    same values."""

    def rebuilt(params, leaves, batch):
        it = iter(leaves)
        return loss_fn(tree_map(lambda _: next(it), params), batch)

    def loss(params, batch):
        return checkpoint(lambda ls, b: rebuilt(params, ls, b), batch,
                          *tree_leaves(params))

    return loss


def _local_sgd(loss_fn: Callable, params, client_batch: dict,
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
            g = tree_map(lambda g_, w_, w0: g_ + prox_mu * (w_ - w0),
                         g, w, params)
        gnorms.append(torch.sqrt(_sq_norm(g)))
        losses.append(loss)
        w = tree_map(lambda w_, g_: torch.add(w_, g_, alpha=-lr), w, g)
    v_k = tree_map(torch.sub, w, params)
    return v_k, torch.stack(losses).mean(), torch.stack(gnorms).mean()


def make_fed_round(loss_fn: Callable, server_opt: Optimizer, *,
                   mode: str = "parallel", remat: bool = False,
                   param_shardings=None, acc_dtype=torch.float32,
                   prox_mu: float = 0.0, cohort_axis=None,
                   cohort_slots: int = None, model_axis=None,
                   param_specs=None):
    """Build the round function

        fed_round(params, opt_state, cohort_batch, weights, client_lr)
            -> (params, opt_state, RoundMetrics)

    ``client_lr`` is a Python float (folded into the step as float32).
    ``remat`` recomputes each local step's activations in its backward
    instead of keeping them (the same values, less memory).
    ``acc_dtype`` is the sequential mode's Δ accumulator (float32 by
    default).  ``param_shardings`` (the sequential mode's FSDP carries)
    is not ported and raises ``NotImplementedError`` (ROADMAP.md queue 1
    item 11, the training programs over a mesh).

    ``cohort_axis``: the client mesh axis (a ``launch.mesh.ClientMesh``)
    of the sharded engine.  The returned function then takes this shard's
    slice of the cohort (batch, weights and a ``slot_mask`` flagging the
    slots of the real K-slot cohort against the shard-count padding),
    trains it in parallel mode, and sums Δ, the loss and the gradient norm
    over the shards; ``cohort_slots`` is the real cohort size K the loss
    and gradient-norm means divide by, as the single-device mean over K
    slots.  The sum order differs from the single-device round's, so the
    sharded round is held to it within float tolerance, not bitwise.

    ``model_axis`` (with ``cohort_axis``): the model mesh axis (a
    ``ClientMesh``) over which the stored parameters and optimizer state
    are split, leaf by leaf as ``param_specs`` says (a spec tree from
    ``sharding.rules.model_specs``, whose entries name the axis by
    ``model_axis.axis``).  The round all-gathers each split leaf along its
    model dim (exact), trains the cohort slice at full width (every rank
    of the model axis computes the same), aggregates all of Δ with one
    ``fed_aggregate`` call, slices this rank's block of each leaf out of
    it before the clients-axis ``all_reduce`` (slicing commutes with the
    sum, so the blocks are the 1-D round's Δ sliced) and applies the
    elementwise server update to the blocks.  The delta norm adds the
    replicated leaves' sum of squares to the model-axis ``all_reduce`` of
    the split leaves' partial sums.  The returned function carries the
    spec tree as ``param_specs`` (None without a model axis), by which
    ``sim.engine_sharded.ShardedEngine`` stores its blocks.
    """
    if mode not in ("parallel", "sequential"):
        raise ValueError(f"mode must be 'parallel' or 'sequential', "
                         f"got {mode!r}")
    if param_shardings is not None:
        raise NotImplementedError(
            "make_fed_round(param_shardings=), the sequential mode's FSDP "
            "carries, is not ported yet: the training programs over a "
            "mesh are ROADMAP.md queue 1 item 11")
    if (model_axis is not None or param_specs is not None) \
            and cohort_axis is None:
        raise ValueError("model_axis and param_specs split the sharded "
                         "engine's stored parameters: they need "
                         "cohort_axis=")
    if remat:
        loss_fn = _rematted(loss_fn)
    if cohort_axis is not None:
        if mode != "parallel":
            raise ValueError("sharded cohort execution is parallel-mode")
        if cohort_slots is None:
            raise ValueError("cohort_axis needs cohort_slots=K")
        if model_axis is not None and param_specs is None:
            raise ValueError("model_axis needs param_specs (a spec tree "
                             "from sharding.rules.model_specs)")
        if model_axis is None and param_specs is not None:
            raise ValueError("param_specs needs model_axis=")
        return _sharded_round(loss_fn, server_opt, prox_mu, cohort_axis,
                              int(cohort_slots), model_axis, param_specs)

    def cohort_parallel(params, cohort_batch, weights, lr):
        deltas, losses, gnorms = vmap(
            lambda b: _local_sgd(loss_fn, params, b, lr, prox_mu))(
                cohort_batch)
        return fed_aggregate_tree(deltas, weights), losses, gnorms

    def cohort_sequential(params, cohort_batch, weights, lr):
        acc = streaming_aggregate_init(params, acc_dtype)
        losses, gnorms = [], []
        for k in range(weights.shape[0]):
            v_k, loss_k, gnorm_k = _local_sgd(
                loss_fn, params, {n: b[k] for n, b in cohort_batch.items()},
                lr, prox_mu)
            acc = streaming_aggregate_add(acc, v_k, weights[k])
            losses.append(loss_k)
            gnorms.append(gnorm_k)
        delta = tree_map(lambda a, p: a.to(p.dtype), acc, params)
        return delta, torch.stack(losses), torch.stack(gnorms)

    cohort = cohort_parallel if mode == "parallel" else cohort_sequential

    def fed_round(params, opt_state, cohort_batch, weights, client_lr):
        delta, losses, gnorms = cohort(params, cohort_batch,
                                       weights.to(torch.float32),
                                       float(client_lr))
        dnorm = torch.sqrt(_sq_norm(delta))
        updates, opt_state = server_opt.update(delta, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, RoundMetrics(loss=losses.mean(),
                                               delta_norm=dnorm,
                                               grad_norm=gnorms.mean())

    return fed_round


def _sharded_round(loss_fn: Callable, server_opt: Optimizer, prox_mu: float,
                   axis, cohort_slots: int, model_axis=None,
                   param_specs=None):
    """The parallel round over one shard's cohort slots, its Δ (this
    rank's blocks of it, with a ``model_axis``) and metrics summed over
    the clients ``axis`` in one ``all_reduce``."""
    def fed_round_sharded(params, opt_state, cohort_batch, weights,
                          client_lr, slot_mask):
        lr = float(client_lr)
        p_full = (params if model_axis is None
                  else gather_full(params, param_specs, model_axis))
        deltas, losses, gnorms = vmap(
            lambda b: _local_sgd(loss_fn, p_full, b, lr, prox_mu))(
                cohort_batch)
        leaves = tree_leaves(deltas)
        k_rows = leaves[0].shape[0]
        flat = torch.cat([x.reshape(k_rows, -1) for x in leaves], dim=1)
        part = fed_aggregate(flat, weights.to(torch.float32))
        sums = torch.stack([(losses * slot_mask).sum(),
                            (gnorms * slot_mask).sum()]).to(part.dtype)
        if model_axis is None:
            shapes = [x.shape[1:] for x in leaves]
        else:
            # this rank's block of each leaf of the whole Δ
            pieces = torch.split(part, [x[0].numel() for x in leaves])
            whole = tree_unflatten(params, [
                p.reshape(x.shape[1:]) for p, x in zip(pieces, leaves)])
            blocks = tree_leaves(local_blocks(whole, param_specs,
                                              model_axis))
            part = torch.cat([b.reshape(-1) for b in blocks])
            shapes = [b.shape for b in blocks]
        total = axis.all_reduce(torch.cat([part, sums]))
        pieces = iter(torch.split(total[:-2], [math.prod(s) for s in shapes]))
        shape_it = iter(shapes)
        delta = tree_map(lambda _: next(pieces).reshape(next(shape_it)),
                         params)
        loss, gnorm = total[-2] / cohort_slots, total[-1] / cohort_slots
        if model_axis is None:
            dnorm = torch.sqrt(_sq_norm(delta))
        else:
            # the replicated leaves are whole on every rank of the model
            # axis: counted once, the split ones summed over it
            sq = {True: [], False: []}
            for x, spec in zip(tree_leaves(delta),
                               specs_up_to(params, param_specs)):
                split = model_dim(spec, model_axis.axis) is not None
                sq[split].append(torch.sum(x * x).to(torch.float32))
            zero = torch.zeros((), dtype=torch.float32, device=part.device)
            dnorm = torch.sqrt(sum(sq[False], zero)
                               + model_axis.all_reduce(sum(sq[True], zero)))
        updates, opt_state = server_opt.update(delta, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, RoundMetrics(loss=loss, delta_norm=dnorm,
                                               grad_norm=gnorm)

    # the layout the sharded engine stores its carry by
    fed_round_sharded.param_specs = param_specs
    return fed_round_sharded
